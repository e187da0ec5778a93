"""The int8 over bf16 wire-error ratio on the smoke's sensor graph at its
full n = 16384, on the reference and on the port, on the same inputs.

`chip_smoke.py` gates the int8 (error feedback) wire at 12x bf16's error
on the BFS general partition and at 10x elsewhere; its first H100 run
read 10.58x there.  This test measures the JAX package's `halo` plan on 4
forced host devices and the port's `halo` and `cuda_halo` plans on 4
gloo ranks (CPU), both partitions, on one graph (numpy seed 0, strip
sorted, SGWT J = 6, K = 20), one batch of 64 signals and one float64
truth (the recurrence over the float64 CSR Laplacian), and holds the
port's ratio to the reference's within 1%, as tests/test_torch_quantize.py
does at n = 2048.  The signals are either a CPU `torch.Generator` draw
(seed 1) or the smoke's own draw on the card, saved by
``python3 chip_smoke.py --save-wire-signal PATH`` and named here by the
environment variable ``WIRE_RATIO_CARD_SIGNAL=PATH`` (the CPU cannot
repeat a CUDA generator's draw; without the file that case skips).  Run
with ``-m slow -s`` to print the readings (about 2 minutes a case).
"""
import json
import math
import os
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _subproc import run_payload

N, J, K, B, SHARDS = 16384, 6, 20, 64, 4
RATIO_TOL = 0.01
PARTS = ("general", "banded")

JAX_PAYLOAD = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.core import wavelets
d = np.load(sys.argv[1] + "/sensor.npz")
sop = wavelets.sgwt_operator(jnp.asarray(d["L"]), float(d["lmax"]),
                             J=%(J)d, K=%(K)d)
mesh = jax.sharding.Mesh(np.array(jax.devices()[:%(S)d]), ("graph",))
out = {}
for part in %(PARTS)r:
    for dt in ("bf16", "int8"):
        y = sop.plan("halo", mesh=mesh, exchange_dtype=dt,
                     partition=part).apply(jnp.asarray(d["F"]))
        out[part + "_" + dt] = np.asarray(y)
np.savez(sys.argv[1] + "/jax.npz", **out)
print("JAX RATIO OK")
"""


def _rel(got, truth):
    got = np.asarray(got, dtype=np.float64)
    return float(np.abs(got - truth).max() / np.abs(truth).max())


def _port_rank(rank, world, tmp):
    from repro_torch.core import wavelets

    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=900))
    try:
        d = np.load(os.path.join(tmp, "sensor.npz"))
        truth = np.load(os.path.join(tmp, "truth.npy"))
        op = wavelets.sgwt_operator(torch.from_numpy(d["L"]),
                                    float(d["lmax"]), J=J, K=K)
        out = {}
        for backend in ("halo", "cuda_halo"):
            for part in PARTS:
                errs = [_rel(op.plan(backend, device="cpu", partition=part,
                                     exchange_dtype=dt).apply(d["F"]),
                             truth) for dt in ("bf16", "int8")]
                out[f"{backend}_{part}"] = errs
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "port.json"), "w") as fh:
            json.dump(out, fh)


def _signals(draw: str) -> torch.Tensor:
    if draw == "cpu":
        return torch.randn(B, N, generator=torch.Generator().manual_seed(1))
    path = os.environ.get("WIRE_RATIO_CARD_SIGNAL")
    if not path:
        pytest.skip("the card's draw: run python3 chip_smoke.py "
                    "--save-wire-signal PATH on the card, then set "
                    "WIRE_RATIO_CARD_SIGNAL=PATH")
    F = torch.from_numpy(np.load(path))
    assert F.shape == (B, N) and F.dtype == torch.float32
    return F


@pytest.mark.slow
@pytest.mark.parametrize("draw", ["cpu", "card"])
def test_sensor_graph_int8_over_bf16_ratio_at_full_n(tmp_path, draw):
    import torch.multiprocessing as mp

    from repro_torch.core import chebyshev as cheb
    from repro_torch.core import graph, wavelets

    kappa = math.sqrt(20.0 / (math.pi * N))
    g = graph.connected_sensor_graph(np.random.RandomState(0), n=N,
                                     theta=kappa * 0.074 / 0.075,
                                     kappa=kappa)
    g, _ = graph.spatial_sort(g)
    L, lmax = g.laplacian().float(), g.lambda_max_bound()
    del g
    F = _signals(draw)
    op = wavelets.sgwt_operator(L.double(), lmax, J=J, K=K)
    Ls = L.double().to_sparse_csr()

    def mv(x):
        return (Ls @ x.reshape(-1, N).T).T.reshape(x.shape)

    truth = cheb.cheb_apply(mv, F.double(), op.coeffs, lmax).numpy()
    np.savez(tmp_path / "sensor.npz", L=L.numpy(), lmax=lmax, F=F.numpy())
    np.save(tmp_path / "truth.npy", truth)
    del L, Ls, op

    out = run_payload(f"import sys; sys.argv = ['-', {str(tmp_path)!r}]\n"
                      + JAX_PAYLOAD % dict(J=J, K=K, S=SHARDS, PARTS=PARTS),
                      n_devices=SHARDS, timeout=1200)
    assert "JAX RATIO OK" in out
    ref = np.load(tmp_path / "jax.npz")
    mp.spawn(_port_rank, args=(SHARDS, str(tmp_path)), nprocs=SHARDS,
             join=True)
    with open(tmp_path / "port.json") as fh:
        port = json.load(fh)
    for part in PARTS:
        want = [_rel(ref[f"{part}_{dt}"], truth) for dt in ("bf16", "int8")]
        ratio = want[1] / want[0]
        print(f"n={N} {draw} draw, {part}: reference bf16 {want[0]!r} int8 {want[1]!r} "
              f"ratio {ratio!r}")
        for backend in ("halo", "cuda_halo"):
            bf16, int8 = port[f"{backend}_{part}"]
            print(f"  port {backend}: bf16 {bf16!r} int8 {int8!r} ratio "
                  f"{int8 / bf16!r}")
            assert abs(int8 / bf16 - ratio) <= RATIO_TOL * ratio
