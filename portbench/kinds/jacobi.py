"""The Jacobi solve of Eq. (24) on den(P) x = num(P) y for a (B, n) stack,
den = tau + P^r and num = tau (the configuration's tau and r), through
the plan's captured solver entry (``plan.compiled_solve("jacobi", tau=,
r=, n_iters=)``, ``n_iters`` the mix's ``rounds``), from x = 0."""
import torch


def entry(plan, cfg: dict, mix: dict):
    return plan.compiled_solve("jacobi", tau=cfg["tau"], r=cfg["r"],
                               n_iters=int(mix["rounds"]))


def inputs(gen, c: dict, count: int, device) -> list:
    return [torch.randn((c["B"], c["n"]), generator=gen, device=device)
            for _ in range(count)]


def reference(ref, y, cfg: dict, mix: dict):
    return ref.jacobi(y, int(mix["rounds"]))


def work(c: dict) -> tuple:
    """(FLOPs, bytes) of one call from the graph and the shapes alone:
    num(P) y once (1 operation per entry); per round r products with P (2
    nnz each per signal), the tau x term (2 per entry) and the update x +
    D^-1 (b - q) (3 per entry); P read once (8 bytes an entry), the
    signals, D^-1 and the solutions once each (f32)."""
    n, nnz, B, r, rounds = c["n"], c["nnz"], c["B"], c["r"], c["rounds"]
    flops = B * (n + rounds * (2 * r * nnz + 5 * n))
    nbytes = 8 * nnz + 4 * B * n + 4 * n + 4 * B * n
    return flops, nbytes
