"""Algorithm 1: Phi~ f for a (B, n) stack of signals, through the plan's
captured ``apply`` entry (``plan.compiled("apply")``)."""
import torch


def entry(plan, cfg: dict, mix: dict):
    return plan.compiled("apply")


def inputs(gen, c: dict, count: int, device) -> list:
    return [torch.randn((c["B"], c["n"]), generator=gen, device=device)
            for _ in range(count)]


def reference(ref, x, cfg: dict, mix: dict):
    return ref.apply(x)


def work(c: dict) -> tuple:
    """(FLOPs, bytes) of one call from the graph and the shapes alone: K
    products with P (2 nnz each per signal), the recurrence (2 operations
    per entry at order 1, 4 after), eta multiply-adds per entry and order
    into the outputs; P read once as values and columns (8 bytes an
    entry), the signals, the coefficients and the outputs once each (f32).
    """
    n, nnz, B, eta, K = c["n"], c["nnz"], c["B"], c["eta"], c["K"]
    flops = B * (2 * K * nnz + n * (2 + 4 * (K - 1)) + 2 * eta * (K + 1) * n)
    nbytes = 8 * nnz + 4 * B * n + 4 * B * eta * n + 4 * eta * (K + 1)
    return flops, nbytes
