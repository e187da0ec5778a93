"""The port's wire codec (`repro_torch.dist.quantize`) and the compressed
exchange of the ring backends, held against the JAX package's
`repro.dist.quantize` and its `halo` plan.

* In process: the same numpy tiles go through both codecs; the int8 and
  bf16 wires are equal byte for byte (int8 as int8, bf16 viewed as 16-bit
  words), decoding either wire gives the same bits, `tile_wire_bytes`
  agrees for h = 1..64, and error feedback beats plain requantization on
  repeated round trips (tests/test_exchange_dtype.py:64-83).
* One spawn of 8 gloo ranks on the CPU (as tests/test_torch_general.py)
  runs the BENCH_comm.json setup (n = 512, half-band 24, K = 20, B = 4) on
  `halo` and `cuda_halo` (the kernels' plain versions), banded and
  general (BFS) partitions, f32, bf16 and int8 with and without error
  feedback.  Against two subprocesses of the JAX `halo` plan on 8 forced
  host devices (tests/_subproc.py) on the same inputs:
  - every output within 1e-5 of the JAX one, relative to its max, but
    int8 without error feedback within 1.5e-4 (one int8 level that falls
    the other way on a general partition); a missing decode scale would
    give O(1), the wire's own error against dense 4.4e-4 (bf16) and
    2.3e-3 (int8, BENCH_comm.json);
  - under link faults (banded and general, f32, bf16 and int8 with error
    feedback, zero_fill and hold_last) the same within 1e-5 of the JAX
    plan run on the same draws: its injector reads the port's host
    Philox draws; with p = 1 (drop, stale) the reference's own injector;
  - 20 rounds and 192 / 96 / 56 bytes per round on the banded plans
    (BENCH_comm.json), the partition's wire bytes on the general ones,
    and the counted totals equal to plan.info's byte models;
  - the error against dense below 1e-5 in f32 and within a factor 2 of
    BENCH_comm.json's 4.4e-4 (bf16) and 2.3e-3 (int8 with error
    feedback) on the banded plans;
  - error feedback beats plain int8 on the streaming setup of
    tests/test_exchange_dtype.py:137-171 (by 4x), and a bf16 Jacobi solve
    is within 5e-2 of the dense one (:196-202);
  - on the smoke's sensor graph cut to n = 2048 (4 of the ranks, 4 of the
    JAX devices, banded and BFS general), the int8 over bf16 error ratio
    against float64 dense is the reference's within 1%.

The JAX package is imported only inside the fixtures and tests: the ranks
import this module to find their entry point and need none of it.
"""
import json
import os
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _subproc import run_payload
from repro_torch.dist import FaultSpec, GraphOperator, plan_comm_stats
from repro_torch.dist import quantize as tq

WORLD = 8
RING = ["halo", "cuda_halo"]
N, BW, K = 512, 24, 20
WIRES = [("f32", True), ("bf16", True), ("int8", True), ("int8", False)]
PARTITIONS = ["banded", "general"]
# BENCH_comm.json: bytes per round at h = 24, and each wire's relative
# error against dense (halo backend)
BENCH_BYTES = {"f32": 192, "bf16": 96, "int8": 56}
BENCH_ERR = {"f32": 2.676175556337972e-07, "bf16": 0.00043947262927663394,
             "int8": 0.0023480075013363037}
# The port's output against the JAX plan's, relative to its max: 1e-5 at
# every wire, but int8 without error feedback on a general partition,
# where one int8 level falls the other way after f32 sums in another
# order and nothing feeds it back (1.1e-4 read here): 1.5e-4.
TOL_VS_JAX = 1e-5
TOL_VS_JAX_INT8_PLAIN = 1.5e-4
STREAM_ROUNDS = 20
# Link faults against the reference on the same draws.  The reference's
# threefry draws cannot be repeated, so its plan runs with an injector
# that reads the port's host Philox draws (`HostDrawInjector` in the
# payload): the same drop and stale decisions and noise masks per (rank,
# round, link).  With p = 1 the reference's own Bernoulli fires whatever
# its key, so those cases run its injector as it is.
FAULT_ARGS = dict(drop_prob=0.2, stale_prob=0.1, noise_prob=0.05, seed=3)
# The smoke's sensor graph (chip_smoke.py: ~20 neighbours per sensor,
# spatially sorted, SGWT J = 6, K = 20, B = 64 signals, 4 shards) cut to
# n = 2048: the int8 (error feedback) over bf16 error ratio against
# float64 dense of the port's plans equals the reference's within 1%.
SENSOR_N, SENSOR_J, SENSOR_B, SENSOR_SHARDS = 2048, 6, 64, 4
RATIO_TOL = 0.01
# label: (spec, degradation, wire, error feedback, the port's draws)
FAULT_CASES = {
    "f32_hold_last": (FAULT_ARGS, "hold_last", "f32", True, True),
    "bf16_zero_fill": (FAULT_ARGS, "zero_fill", "bf16", True, True),
    "int8_ef_hold_last": (FAULT_ARGS, "hold_last", "int8", True, True),
    "drop1_int8_ef_hold_last": ({"drop_prob": 1.0}, "hold_last", "int8",
                                True, False),
    "stale1_f32_zero_fill": ({"stale_prob": 1.0}, "zero_fill", "f32", True,
                             False),
}


def _key(part, dt, ef):
    return f"{part}_{dt}_{int(ef)}"


# ---------------------------------------------------------------------------
# The codec, in process
# ---------------------------------------------------------------------------
def _tile(shape, seed, zero_row=False):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape)
         * rng.uniform(0.01, 100.0, shape[:-1] + (1,))).astype(np.float32)
    if zero_row:
        x[(0,) * (len(shape) - 1)] = 0.0
    return x


TILES = [((3, 7), False), ((4, 24), False), ((2, 5, 327), False),
         ((4, 24), True)]


def _bits(w) -> np.ndarray:
    """A wire's bytes as unsigned words (bf16 as 16-bit, int8 as 8-bit)."""
    w = np.asarray(w) if not isinstance(w, torch.Tensor) else w
    if isinstance(w, torch.Tensor):
        if w.dtype == torch.bfloat16:
            return w.view(torch.int16).numpy().view(np.uint16)
        return w.numpy().view(np.uint8)
    return w.view(np.uint16 if w.dtype.itemsize == 2 else np.uint8)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("shape,zero_row", TILES)
def test_wire_bytes_equal_jax(shape, zero_row, dtype):
    import jax.numpy as jnp

    from repro.dist import quantize as jq

    x = _tile(shape, sum(shape), zero_row)
    want = jq.encode(jnp.asarray(x), dtype)
    got = tq.encode(torch.from_numpy(x), dtype)
    assert str(got.dtype) == {"bf16": "torch.bfloat16",
                              "int8": "torch.int8"}[dtype]
    assert tuple(got.shape) == tuple(want.shape)
    assert np.array_equal(_bits(got), _bits(want))
    # decoding either wire gives the same bits
    back_t = tq.decode(got, dtype).numpy()
    back_j = np.asarray(jq.decode(want, dtype))
    assert np.array_equal(back_t, back_j)
    if zero_row:
        assert not back_t[(0,) * (len(shape) - 1)].any()


def test_f32_wire_is_the_tile():
    x = torch.from_numpy(_tile((4, 24), 1))
    assert tq.encode(x, "f32") is x
    assert tq.decode(x, "f32") is x


def test_tile_wire_bytes_equal_jax():
    from repro.dist import quantize as jq

    assert tq.EXCHANGE_DTYPES == jq.EXCHANGE_DTYPES
    for h in range(1, 65):
        for dt in tq.EXCHANGE_DTYPES:
            assert tq.tile_wire_bytes(h, dt) == jq.tile_wire_bytes(h, dt)
        # the wire's own size is the model
        x = torch.ones(3, h)
        assert (tq.encode(x, "int8").numel() * 1
                == 3 * tq.tile_wire_bytes(h, "int8"))
        assert (tq.encode(x, "bf16").numel() * 2
                == 3 * tq.tile_wire_bytes(h, "bf16"))


@pytest.mark.parametrize("bad", ["f16", "int4", "fp8"])
def test_validate_exchange_dtype(bad):
    for dt in tq.EXCHANGE_DTYPES:
        assert tq.validate_exchange_dtype(dt) == dt
    with pytest.raises(ValueError):
        tq.validate_exchange_dtype(bad)
    with pytest.raises(ValueError):
        tq.tile_wire_bytes(8, bad)


def test_int8_roundtrip_within_half_a_level():
    """tests/test_exchange_dtype.py:52: |decode(encode(x)) - x| <= 0.5/127
    of the row's max-abs (+ 1e-6)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (6, 24)).astype(np.float32))
    back = tq.decode(tq.encode(x, "int8"), "int8")
    scale = x.abs().amax(-1, keepdim=True)
    assert float(((back - x).abs() / scale).max()) <= 0.5 / 127 + 1e-6
    assert float((tq.decode(tq.encode(x, "bf16"), "bf16") - x)
                 .abs().max()) < 2e-2


def test_ef_encode_equals_jax():
    """Five rounds of error-feedback encoding: the same wires and the
    same residuals as the reference's, bit for bit."""
    import jax.numpy as jnp

    from repro.dist import quantize as jq

    x = _tile((4, 24), 7)
    rj = jq.ef_init(jnp.asarray(x))
    rt = tq.ef_init(torch.from_numpy(x))
    assert rt.dtype == torch.float32 and not rt.any()
    for _ in range(5):
        wj, rj = jq.ef_encode(jnp.asarray(x), rj, "int8")
        wt, rt = tq.ef_encode(torch.from_numpy(x), rt, "int8")
        assert np.array_equal(_bits(wt), _bits(wj))
        assert np.array_equal(rt.numpy(), np.asarray(rj))


def test_error_feedback_beats_plain_requantization():
    """tests/test_exchange_dtype.py:64-83 on the port: 40 round trips of
    the same tile; the error-feedback sum stays near one round's floor,
    plain requantization drifts (EF error under a quarter of plain)."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 24)).astype(np.float32))
    acc_plain = torch.zeros_like(x)
    acc_ef = torch.zeros_like(x)
    r = tq.ef_init(x)
    rounds = 40
    for _ in range(rounds):
        acc_plain += tq.decode(tq.encode(x, "int8"), "int8")
        wire, r = tq.ef_encode(x, r, "int8")
        acc_ef += tq.decode(wire, "int8")
    target = x * rounds
    err_plain = float((acc_plain - target).abs().max())
    err_ef = float((acc_ef - target).abs().max())
    assert err_ef < err_plain / 4, (err_ef, err_plain)


# ---------------------------------------------------------------------------
# 8 ranks: the compressed exchange of the sharded plans
# ---------------------------------------------------------------------------
def _banded_operator_P(n, bw, seed=0):
    """`benchmarks/bench_comm.py:128 _banded_operator` (a numpy copy)."""
    rng = np.random.default_rng(seed)
    Bm = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - bw), min(n, i + bw + 1)
        Bm[i, lo:hi] = rng.standard_normal(hi - lo) * 0.1
    Bm = np.abs(Bm + Bm.T) / 2
    L = np.diag(Bm.sum(1)) - Bm
    lmax = float(2 * Bm.sum(1).max())
    x = rng.standard_normal((4, n)).astype(np.float32)
    return L, lmax, x


def _sensor_setup():
    """The smoke's sensor graph, its SGWT multipliers' float64 dense
    output on B signals, at n = SENSOR_N."""
    import math

    from repro_torch.core import graph, wavelets

    n = SENSOR_N
    kappa = math.sqrt(20.0 / (math.pi * n))
    g = graph.connected_sensor_graph(np.random.RandomState(0), n=n,
                                     theta=kappa * 0.074 / 0.075,
                                     kappa=kappa)
    g, _ = graph.spatial_sort(g)
    L, lmax = g.laplacian().float(), g.lambda_max_bound()
    F = torch.randn(SENSOR_B, n, generator=torch.Generator().manual_seed(1))
    op = wavelets.sgwt_operator(L.double(), lmax, J=SENSOR_J, K=K)
    truth = op.plan("dense", device="cpu").apply(F.double()).numpy()
    return {"L": L.numpy(), "lmax": lmax, "F": F.numpy(), "truth": truth}


def _sensor_ratios(group, sensor):
    """The port's bf16 and int8 errors against float64 dense and their
    ratio, per backend and partition, on the 4-rank `group`."""
    from repro_torch.core import wavelets

    op = wavelets.sgwt_operator(torch.from_numpy(sensor["L"]),
                                sensor["lmax"], J=SENSOR_J, K=K)
    out = {}
    for backend in RING:
        for part in PARTITIONS:
            errs = [_rel(op.plan(backend, device="cpu", mesh=group,
                                 partition=part, exchange_dtype=dt)
                         .apply(sensor["F"]).numpy(), sensor["truth"])
                    for dt in ("bf16", "int8")]
            out[f"{backend}_{part}"] = errs + [errs[1] / errs[0]]
    return out


def _op(setup):
    return GraphOperator(P=torch.tensor(setup["L"]),
                         multipliers=[lambda lam: np.exp(-lam)],
                         lmax=setup["lmax"], K=K)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _streaming_errs(op, x, L):
    """tests/test_exchange_dtype.py:137-171: R matvecs of the same x
    through the int8 exchange, summed, against R L x."""
    from repro_torch.core.chebyshev import _stateful_matvec

    exact = (torch.as_tensor(x) @ torch.as_tensor(L).T).numpy() * \
        STREAM_ROUNDS
    errs = {}
    for label, ef in (("ef", True), ("plain", False)):
        plan = op.plan("halo", device="cpu", exchange_dtype="int8",
                       error_feedback=ef)

        def fn(mv, xl):
            mv2, st = _stateful_matvec(mv, xl)
            acc = torch.zeros_like(xl)
            for _ in range(STREAM_ROUNDS):
                h, st = mv2(xl, st)
                acc = acc + h
            return acc

        errs[label] = _rel(plan.matvec_runner(fn, (x,)).numpy(), exact)
    return errs


def _rank_checks(rank, setup):
    op = _op(setup)
    x = setup["x"]
    out = {"rank": rank, "plans": {}}
    for backend in RING:
        for part in PARTITIONS:
            for dt, ef in WIRES:
                plan = op.plan(backend, device="cpu", partition=part,
                               exchange_dtype=dt, error_feedback=ef)
                st = plan_comm_stats(plan)
                stb = plan_comm_stats(plan, batch=16)["apply"]
                y = plan.apply(x).numpy()
                info = plan.info
                out["plans"][f"{backend}_{_key(part, dt, ef)}"] = {
                    "rounds": [st["apply"].exchange_rounds,
                               st["apply_adjoint"].exchange_rounds,
                               st["apply_gram"].exchange_rounds,
                               stb.exchange_rounds],
                    "bytes_per_round": st["apply"].bytes_per_round,
                    "total_bytes": [st["apply"].total_bytes,
                                    st["apply_adjoint"].total_bytes],
                    "model": [info["halo_bytes_per_apply"],
                              info["halo_bytes_per_adjoint"]],
                    # the sum over the offsets of each tile's wire row
                    "wire_model": (K * WORLD * sum(
                        tq.tile_wire_bytes(h, dt)
                        for h in info["partition_tile_widths"])
                        if part == "general" else None),
                    "info": [info["exchange_dtype"], info["error_feedback"],
                             info["fault_key"], info["fault_spec"],
                             info["degradation"]],
                    "vs_jax": _rel(y, setup["jax"][_key(part, dt, ef)]),
                    "vs_dense": _rel(y, setup["jax"]["dense"]),
                }
    out["faults"] = {}
    for label, (args, deg, dt, ef, _) in FAULT_CASES.items():
        for backend in RING:
            for part in PARTITIONS:
                plan = op.plan(backend, device="cpu", partition=part,
                               exchange_dtype=dt, error_feedback=ef,
                               fault_spec=FaultSpec(**args),
                               degradation=deg)
                y = plan.apply(x).numpy()
                out["faults"][f"{backend}_{part}_{label}"] = {
                    "vs_jax": _rel(y, setup["jax"][f"fault_{part}_{label}"]),
                    "vs_clean": _rel(y, setup["jax"][_key(part, dt, ef)]),
                }
    out["streaming"] = _streaming_errs(op, x, setup["L"])
    sub = dist.new_group(list(range(SENSOR_SHARDS)))
    if rank < SENSOR_SHARDS:
        out["sensor"] = _sensor_ratios(sub, setup["sensor"])
    y = setup["jax"]["dense"][:, 0, :]
    plan16 = op.plan("halo", device="cpu", exchange_dtype="bf16")
    x32 = setup["jax"]["solve_dense"]
    x16 = plan16.solve(y, "jacobi", tau=0.5, n_iters=15).x.numpy()
    out["bf16_solve_rel"] = _rel(x16, x32)
    return out


def _worker(rank, world, tmp, setup):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        out = _rank_checks(rank, setup)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


JAX_PAYLOAD_HEAD = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.dist.operator import GraphOperator

L = np.load(sys.argv[1] + "/L.npy")
x = np.load(sys.argv[1] + "/x.npy")
lmax = float(np.load(sys.argv[1] + "/lmax.npy"))
op = GraphOperator(P=jnp.asarray(L), multipliers=[lambda lam: np.exp(-lam)],
                   lmax=lmax, K=%(K)d)
mesh = jax.make_mesh((8,), ("graph",),
                     axis_types=(jax.sharding.AxisType.Auto,))
"""

JAX_PAYLOAD = r"""
dense = op.plan("dense")
out = {"dense": np.asarray(dense.apply(jnp.asarray(x)))}
out["solve_dense"] = np.asarray(dense.solve(
    jnp.asarray(out["dense"][:, 0, :]), "jacobi", tau=0.5, n_iters=15).x)
for part in ("banded", "general"):
    for dt, ef in %(WIRES)r:
        plan = op.plan("halo", mesh=mesh, exchange_dtype=dt,
                       error_feedback=ef, partition=part)
        out["%%s_%%s_%%d" %% (part, dt, int(ef))] = np.asarray(
            plan.apply(jnp.asarray(x)))

# the sensor graph on 4 of the 8 devices: bf16 and int8 (error feedback)
from repro.core import wavelets
sensor = np.load(sys.argv[1] + "/sensor.npz")
sop = wavelets.sgwt_operator(jnp.asarray(sensor["L"]),
                             float(sensor["lmax"]), J=%(SENSOR_J)d, K=%(K)d)
mesh4 = jax.sharding.Mesh(np.array(jax.devices()[:%(SENSOR_SHARDS)d]),
                          ("graph",))
for part in ("banded", "general"):
    for dt in ("bf16", "int8"):
        plan = sop.plan("halo", mesh=mesh4, exchange_dtype=dt, partition=part)
        out["sensor_%%s_%%s" %% (part, dt)] = np.asarray(
            plan.apply(jnp.asarray(sensor["F"])))
np.savez(sys.argv[1] + "/jax.npz", **out)
print("JAX HALO OK")
"""

JAX_FAULT_PAYLOAD = r"""
# link faults: the reference's plan, its injector reading the port's draws
import dataclasses
from repro.dist import faults as jf
from repro_torch.dist import faults as tf


class HostDrawInjector(jf.LinkFaultInjector):
    # the reference's injector with the port's host Philox draws, as
    # tables over (shard, round) read at the traced shard and round

    def _table(self, draw):
        spec = tf.FaultSpec(**dataclasses.asdict(self.spec))
        ports = [tf.LinkFaultInjector(spec, self.degradation, s)
                 for s in range(8)]
        return jnp.asarray(np.stack([np.stack(
            [draw(inj, r) for r in range(%(K)d)]) for inj in ports]))

    def _at(self, table, round_idx):
        return table[jax.lax.axis_index(self.axis), round_idx]

    def _masks(self, shape, link, np_dtype):
        p = self.spec.noise_prob
        return self._table(lambda inj, r: tf._mask_bits(
            inj._rng(r, link, tf._SALT_NOISE), tuple(shape), p, np_dtype))

    def wire(self, wire, round_idx, link, exchange_dtype):
        if self.spec.noise_prob <= 0.0 or exchange_dtype == "f32":
            return wire
        if exchange_dtype == "bf16":
            bits = jax.lax.bitcast_convert_type(wire, jnp.uint16)
            bits = bits ^ self._at(self._masks(wire.shape, link, np.uint16),
                                   round_idx)
            return jax.lax.bitcast_convert_type(bits, jnp.bfloat16)
        payload, scale = wire[..., :-4], wire[..., -4:]
        bits = jax.lax.bitcast_convert_type(payload, jnp.uint8)
        bits = bits ^ self._at(self._masks(payload.shape, link, np.uint8),
                               round_idx)
        return jnp.concatenate(
            [jax.lax.bitcast_convert_type(bits, jnp.int8), scale], axis=-1)

    def recv(self, tile, carried, round_idx, link):
        out = tile
        if self.spec.stale_prob > 0.0:
            stale = self._table(lambda inj, r: inj._bernoulli(
                r, link, tf._SALT_STALE, self.spec.stale_prob))
            out = jnp.where(self._at(stale, round_idx), carried, out)
        if self.spec.drop_prob > 0.0:
            drop = self._table(lambda inj, r: inj._bernoulli(
                r, link, tf._SALT_DROP, self.spec.drop_prob))
            fallback = (carried if self.degradation == "hold_last"
                        else jnp.zeros_like(out))
            out = jnp.where(self._at(drop, round_idx), fallback, out)
        return out, out


out = {}
reference_injector = jf.LinkFaultInjector
for label, (args, deg, dt, ef, port_draws) in %(FAULT_CASES)r.items():
    jf.LinkFaultInjector = (HostDrawInjector if port_draws
                            else reference_injector)
    for part in ("banded", "general"):
        plan = op.plan("halo", mesh=mesh, exchange_dtype=dt,
                       error_feedback=ef, partition=part,
                       fault_spec=jf.FaultSpec(**args), degradation=deg)
        out["fault_%%s_%%s" %% (part, label)] = np.asarray(
            plan.apply(jnp.asarray(x)))
jf.LinkFaultInjector = reference_injector
np.savez(sys.argv[1] + "/jax_faults.npz", **out)
print("JAX HALO OK")
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The BENCH_comm.json inputs and the JAX `halo` plan's outputs on
    them, clean and faulted (two subprocesses on 8 forced host devices),
    and the sensor graph's inputs and outputs."""
    L, lmax, x = _banded_operator_P(N, BW)
    tmp = tmp_path_factory.mktemp("jax_halo")
    np.save(tmp / "L.npy", L)
    np.save(tmp / "x.npy", x)
    np.save(tmp / "lmax.npy", np.float64(lmax))
    sensor = _sensor_setup()
    np.savez(tmp / "sensor.npz", L=sensor["L"], lmax=sensor["lmax"],
             F=sensor["F"])
    fill = {"K": K, "WIRES": WIRES, "FAULT_CASES": FAULT_CASES,
            "SENSOR_J": SENSOR_J, "SENSOR_SHARDS": SENSOR_SHARDS}
    head = (f"import sys; sys.argv = ['-', {str(tmp)!r}]\n"
            + JAX_PAYLOAD_HEAD % fill)
    # the clean and the faulted plans in two subprocesses at once
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(run_payload, head + body % fill, WORLD)
                for body in (JAX_PAYLOAD, JAX_FAULT_PAYLOAD)]
        for run in runs:
            assert "JAX HALO OK" in run.result()
    jax_out = {}
    for name in ("jax", "jax_faults"):
        with np.load(tmp / f"{name}.npz") as z:
            jax_out.update({k: z[k] for k in z.files})
    return {"L": L, "lmax": lmax, "x": x, "jax": jax_out, "sensor": sensor}


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("gloo8_quantize")
    mp.spawn(_worker, args=(WORLD, str(tmp), setup), nprocs=WORLD,
             join=True)
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


def test_jax_reference_reproduces_bench_comm(setup):
    """The JAX plan in the subprocesses is BENCH_comm.json's: its errors
    against dense are the tracked ones (to 1e-6 relative of each)."""
    for dt, ef in WIRES:
        if not ef:
            continue
        got = _rel(setup["jax"][_key("banded", dt, ef)],
                   setup["jax"]["dense"])
        assert abs(got - BENCH_ERR[dt]) <= 1e-6 * max(BENCH_ERR[dt], 1e-3)


@pytest.mark.parametrize("dt,ef", WIRES)
@pytest.mark.parametrize("part", PARTITIONS)
@pytest.mark.parametrize("backend", RING)
def test_outputs_match_jax_halo_plan(ranks, backend, part, dt, ef):
    tol = TOL_VS_JAX if (dt, ef) != ("int8", False) else \
        TOL_VS_JAX_INT8_PLAIN
    for r in ranks:
        rec = r["plans"][f"{backend}_{_key(part, dt, ef)}"]
        assert rec["vs_jax"] <= tol, (r["rank"], rec["vs_jax"])


@pytest.mark.parametrize("dt,ef", WIRES)
@pytest.mark.parametrize("part", PARTITIONS)
@pytest.mark.parametrize("backend", RING)
def test_rounds_and_bytes_per_wire(ranks, backend, part, dt, ef):
    for r in ranks:
        rec = r["plans"][f"{backend}_{_key(part, dt, ef)}"]
        # K rounds for apply and adjoint, 2K for Gram, batch-invariant
        assert rec["rounds"] == [K, K, 2 * K, K]
        assert rec["total_bytes"] == rec["model"]
        if part == "banded":
            assert rec["bytes_per_round"] == BENCH_BYTES[dt]
        else:
            assert rec["total_bytes"][0] == rec["wire_model"]
        assert rec["info"] == [dt, ef, "none", None, "zero_fill"]


@pytest.mark.parametrize("dt", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("backend", RING)
def test_error_against_dense_is_the_wire_error(ranks, backend, dt):
    """f32 under 1e-5; bf16 and int8 (error feedback) within a factor 2
    of BENCH_comm.json's errors, on both sides (a codec that dropped the
    wire's rounding or its scale would leave that band)."""
    for r in ranks:
        for part in PARTITIONS:
            err = r["plans"][f"{backend}_{_key(part, dt, True)}"]["vs_dense"]
            if dt == "f32":
                assert err < 1e-5, (part, err)
            else:
                assert BENCH_ERR[dt] / 2 <= err <= 2 * BENCH_ERR[dt], (
                    part, err)


@pytest.mark.parametrize("label", list(FAULT_CASES))
@pytest.mark.parametrize("part", PARTITIONS)
@pytest.mark.parametrize("backend", RING)
def test_faulted_outputs_match_jax_halo_plan(ranks, backend, part, label):
    """The faulted apply against the JAX `halo` plan on the same draws
    (noise, decode, stale, drop, the carried tiles, the link ids and the
    error-feedback residuals through the faulted rounds), at the wire's
    tolerance; the faults really change the output."""
    for r in ranks:
        rec = r["faults"][f"{backend}_{part}_{label}"]
        assert rec["vs_jax"] <= TOL_VS_JAX, (r["rank"], rec)
        assert rec["vs_clean"] > 1e-3, (r["rank"], rec)


@pytest.mark.parametrize("part", PARTITIONS)
@pytest.mark.parametrize("backend", RING)
def test_sensor_graph_int8_over_bf16_ratio_is_the_references(
        setup, ranks, backend, part):
    """chip_smoke.py gates int8 against bf16's error on the sensor graph;
    at n = 2048 the port's ratio is the reference's within 1% (printed
    with -s)."""
    sensor = setup["sensor"]
    jax_errs = [_rel(setup["jax"][f"sensor_{part}_{dt}"], sensor["truth"])
                for dt in ("bf16", "int8")]
    want = jax_errs[1] / jax_errs[0]
    bf16, int8, ratio = ranks[0]["sensor"][f"{backend}_{part}"]
    print(f"n={SENSOR_N} {part}: reference bf16 {jax_errs[0]!r} int8 "
          f"{jax_errs[1]!r} ratio {want!r}; port {backend} bf16 {bf16!r} "
          f"int8 {int8!r} ratio {ratio!r}")
    for r in ranks[:SENSOR_SHARDS]:
        bf16, int8, ratio = r["sensor"][f"{backend}_{part}"]
        assert abs(ratio - want) <= RATIO_TOL * want, (r["rank"], ratio,
                                                       want)


def test_error_feedback_beats_plain_int8_streaming(ranks):
    for r in ranks:
        s = r["streaming"]
        assert s["ef"] < s["plain"] / 4, s


def test_bf16_exchange_jacobi_solve_still_solves(ranks):
    for r in ranks:
        assert r["bf16_solve_rel"] < 5e-2, r["bf16_solve_rel"]


def test_every_rank_sees_the_same_outputs(ranks):
    for key in ranks[0]["plans"]:
        assert len({r["plans"][key]["vs_jax"] for r in ranks}) == 1, key
