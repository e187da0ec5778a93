"""plan.build_s: the host's seconds from the program's Laplacian of W to
``plan("cuda")`` returned (the operator's ``build``: the Laplacian and
its bound, the coefficients, the host's Block-ELL packing and the
sliced-ELL layout on the card), a span the harness takes around it."""


def read(ctx):
    return ctx.build_s
