"""kernels.roofline_pct: the least time the window's work could take on
the card over the summed device time of its operations, in percent.

The work of a call is counted by its kind from the graph and the shapes
alone (`kinds/<kind>.py: work`); the least time of a call is the larger
of its bytes over the HBM bandwidth and its FLOPs over the float32 rate
outside the tensor cores, at the H100 SXM data sheet's peaks (which
assume its 700 W power limit; the run prints the card's limit)."""

#: H100 SXM, NVIDIA's data sheet: HBM3 bytes/s, f32 FLOP/s (CUDA cores).
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12


def read(ctx):
    if ctx.summary is None or ctx.summary.op_s <= 0:
        return None
    flops, nbytes = ctx.work
    least = max(nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS)
    return 100.0 * ctx.calls * least / ctx.summary.op_s
