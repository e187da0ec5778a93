"""Synthesis: Phi~* a for a (B, eta, n) stack, through the plan's captured
``apply_adjoint`` entry (``plan.compiled("apply_adjoint")``)."""
import torch


def entry(plan, cfg: dict, mix: dict):
    return plan.compiled("apply_adjoint")


def inputs(gen, c: dict, count: int, device) -> list:
    return [torch.randn((c["B"], c["eta"], c["n"]), generator=gen,
                        device=device) for _ in range(count)]


def reference(ref, a, cfg: dict, mix: dict):
    return ref.adjoint(a)


def work(c: dict) -> tuple:
    """(FLOPs, bytes) of one call from the graph and the shapes alone: K
    products with P over B eta columns, the recurrence on every column (2
    operations per entry at order 1, 4 after), eta multiply-adds per
    output entry and order; P read once (8 bytes an entry), the inputs,
    the coefficients and the outputs once each (f32)."""
    n, nnz, B, eta, K = c["n"], c["nnz"], c["B"], c["eta"], c["K"]
    flops = B * (2 * K * nnz * eta + eta * n * (2 + 4 * (K - 1))
                 + 2 * eta * (K + 1) * n)
    nbytes = 8 * nnz + 4 * B * eta * n + 4 * B * n + 4 * eta * (K + 1)
    return flops, nbytes
