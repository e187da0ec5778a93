"""The port's trainer, held against the JAX package's on the same numpy
inputs: `SyntheticLMData`, AdamW with the global-norm clip, the train step,
checkpoints in both directions, the launcher's fail-and-resume protocol
and its gossip data parallelism on 4 gloo ranks.

JAX weights and optimizer state cross with `convert.lm_params_from_numpy`
/ `adamw_state_from_numpy`.  Tolerances (float32, the reduced presets):

- `SyntheticLMData`: bit for bit (the same numpy code);
- AdamW on identical gradients: f32 params, m and v within 1e-6 of the
  leaf's largest magnitude (the same elementwise f32 arithmetic; XLA may
  contract a product and a sum into one rounding); bf16 params within one
  bf16 ulp (2**-8 of the value) of the JAX ones; the global norm 1e-6
  relative;
- the train step (forward and backward in another summation order, then
  AdamW), after 1 and 3 steps at lr 1e-3: loss 1e-5, grad norm 1e-5
  relative, params 2e-5 absolute (a gradient within rounding of zero
  moves its weight by up to lr * |g| / (|g| + eps)), m and v 5e-5 of each
  leaf's largest magnitude;
- checkpoints: keys, shapes, manifest and array bytes equal;
- the launcher: the resumed run prints the uninterrupted run's losses at
  steps 12, 15 and 17 (tests/test_checkpoint.py's protocol); the 4-rank
  gossip run's losses within 1e-5 of the JAX plain trainer's on the same
  weights (exact consensus at K = 2), and 5e-3 with int8 messages.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import latest_checkpoint as jlatest
from repro.ckpt import load_checkpoint as jload
from repro.ckpt import restore_arrays as jrestore
from repro.ckpt import save_checkpoint as jsave
from repro.configs import get_config as jget_config
from repro.data import SyntheticLMData as JData
from repro.dist.sharding import ShardingRules
from repro.models import init_params as jinit_params
from repro.models.model import RunConfig as JRunConfig
from repro.models.steps import build_loss_fn as jbuild_loss_fn
from repro.models.steps import build_train_step as jbuild_train_step
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import clip_by_global_norm as jclip
from repro_torch import tree as ttree
from repro_torch.ckpt import (latest_checkpoint, load_checkpoint,
                              restore_arrays, save_checkpoint)
from repro_torch.ckpt.checkpoint import wait_pending
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.data import SyntheticLMData
from repro_torch.launch import train
from repro_torch.models import steps
from repro_torch.models.model import RunConfig
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm
from repro_torch.optim import adamw as tadamw

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
RULES = ShardingRules.null()
LR = 1e-3
TOL_LOSS, TOL_GNORM, TOL_PARAMS, TOL_MOMENTS = 1e-5, 1e-5, 2e-5, 5e-5


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _np(x):
    return np.asarray(x, np.float32)


def _host(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else _np(t)


def _max_rel(got, want):
    """max over leaves of max |got - want| / max |want| (float32)."""
    want = dict(_flat(want))
    return max(float(np.abs(_host(g) - _np(want[k])).max()
                     / max(float(np.abs(_np(want[k])).max()), 1e-30))
               for k, g in _flat(got))


# ---------------------------------------------------------------------------
# SyntheticLMData
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(vocab_size=256, seq_len=16, global_batch=2),
    dict(vocab_size=49152, seq_len=256, global_batch=8),
    dict(vocab_size=256, seq_len=32, global_batch=4, seed=3, noise=0.2,
         n_vision_tokens=8, d_model=64),
    dict(vocab_size=100, seq_len=12, global_batch=3, seed=7,
         encoder_seq=24, d_model=16),
])
def test_synthetic_lm_data_bit_equal(kw):
    ours, ref = SyntheticLMData(**kw), JData(**kw)
    for step in (0, 1, 12, 10**6):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (step, k)
    it_a, it_b = ours.iterate(5), ref.iterate(5)
    for _ in range(2):
        assert next(it_a)["tokens"].tobytes() == \
            next(it_b)["tokens"].tobytes()


# ---------------------------------------------------------------------------
# AdamW and the clip on identical gradients
# ---------------------------------------------------------------------------
def _tree(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {"b": (scale * rs.randn(5)).astype(np.float32),
            "a": {"w": (scale * rs.randn(3, 4, 6)).astype(np.float32),
                  "c": (scale * rs.randn(2, 7)).astype(np.float32)}}


@pytest.mark.parametrize("max_norm", [1.0, 1e3])     # clipped / not
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_and_clip_match_jax_over_three_steps(dtype, max_norm):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    p0 = _tree(0, 0.02)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p0)
    tp = {k: ({n: torch.from_numpy(a).to(tdt) for n, a in v.items()}
              if isinstance(v, dict) else torch.from_numpy(v).to(tdt))
          for k, v in p0.items()}
    js, ts = jadamw_init(jp), adamw_init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    assert all(m.dtype == torch.float32 for _, m in _flat(ts.m))
    for step in range(3):
        g = _tree(10 + step)
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g)
        tg = lm_params_from_numpy(jax.tree.map(np.asarray, jg))
        jgc, jgn = jclip(jg, max_norm)
        tgc, tgn = clip_by_global_norm(tg, max_norm)
        # the clip widens: a bf16 gradient times its f32 scale is f32
        assert {str(a.dtype) for a in jax.tree.leaves(jgc)} == {"float32"}
        assert {t.dtype for _, t in _flat(tgc)} == {torch.float32}
        assert tgn.dtype == torch.float32 and tgn.ndim == 0
        assert abs(float(tgn) - float(jgn)) <= 1e-6 * float(jgn)
        assert _max_rel(tgc, jgc) <= 1e-6
        jp, js = jadamw_update(jgc, js, jp, lr=LR)
        out, ts = adamw_update(tgc, ts, tp, lr=LR)
        assert out is tp and int(ts.step) == int(js.step) == step + 1
        if dtype == "f32":
            assert _max_rel(tp, jp) <= 1e-6
        else:
            want = dict(_flat(jp))
            for k, t in _flat(tp):
                assert t.dtype == torch.bfloat16
                w = _np(want[k])
                assert np.all(np.abs(t.float().numpy() - w)
                              <= np.abs(w) * 2.0 ** -8), k
        assert _max_rel(ts.m, js.m) <= 1e-6
        assert _max_rel(ts.v, js.v) <= 1e-6


def test_grad_scale_is_the_clipped_tree_bit_for_bit():
    """The trainer's path (the clip scale inside the update, bf16 grads
    never widened as a tree) equals clip-then-update bit for bit."""
    def fresh():
        return {k: torch.from_numpy(v).to(torch.bfloat16)
                for k, v in _flat(_tree(0, 0.02))}

    g = {k: torch.from_numpy(v).to(torch.bfloat16)
         for k, v in _flat(_tree(5))}
    pa, pb = fresh(), fresh()
    sa, sb = adamw_init(pa), adamw_init(pb)
    gc, gn = clip_by_global_norm(g, 1.0)
    adamw_update(gc, sa, pa, lr=LR)
    gn2 = tadamw.global_norm(g)
    adamw_update(g, sb, pb, lr=LR, grad_scale=tadamw.clip_scale(gn2, 1.0))
    assert torch.equal(gn, gn2)
    for k in pa:
        assert torch.equal(pa[k], pb[k]) and torch.equal(sa.m[k], sb.m[k])


def test_update_walks_large_leaves_in_slices(monkeypatch):
    """A leaf over CHUNK elements is updated slice by slice along its
    leading axis, with the same bits as in one piece."""
    rs = np.random.RandomState(2)
    p = {"w": torch.from_numpy(rs.randn(6, 5, 4).astype(np.float32))}
    g = {"w": torch.from_numpy(rs.randn(6, 5, 4).astype(np.float32))}
    whole = {"w": p["w"].clone()}
    s_whole = adamw_init(whole)
    adamw_update(g, s_whole, whole, lr=LR)
    monkeypatch.setattr(tadamw, "CHUNK", 40)        # two rows at a time
    assert [c.shape[0] for c in tadamw._chunks(p["w"])] == [2, 2, 2]
    s = adamw_init(p)
    adamw_update(g, s, p, lr=LR)
    assert torch.equal(p["w"], whole["w"])
    assert torch.equal(s.v["w"], s_whole.v["w"])
    assert float(tadamw.global_norm(g)) == pytest.approx(
        float(g["w"].norm()), rel=1e-6)


def test_tree_walks_leaves_in_the_jax_order():
    """`repro_torch.tree` visits a tree of dicts (keys inserted unsorted),
    a named tuple, a list and a tuple in `jax.tree_util`'s leaf order and
    paths, and `map_with_path` rebuilds the same structure."""
    leaf = iter(range(100))
    tree = {"z": [next(leaf), (next(leaf), next(leaf))],
            "a": tadamw.AdamWState(step=next(leaf), m={"y": next(leaf),
                                                       "b": next(leaf)},
                                   v={"q": next(leaf)}),
            "m": {"k": next(leaf)}}

    def key(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return getattr(k, attr)
        raise TypeError(k)

    want = [(tuple(key(k) for k in path), x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert list(ttree.leaves_with_paths(tree)) == want
    assert ttree.leaves(tree) == [x for _, x in want]
    rebuilt = ttree.map_with_path(lambda path, x: str((path, x)), tree)
    assert jax.tree_util.tree_structure(rebuilt) == \
        jax.tree_util.tree_structure(tree)
    assert ttree.leaves(rebuilt) == [str(pair) for pair in want]
    assert ttree.leaves(ttree.tree_map(lambda x: 2 * x, tree)) == [
        2 * x for _, x in want]


# ---------------------------------------------------------------------------
# the train step on every reduced preset
# ---------------------------------------------------------------------------
def _data(cfg, batch=2, seq=16):
    return SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0,
        n_vision_tokens=cfg.n_vision_tokens if cfg.family == "vlm" else 0,
        d_model=cfg.d_model, encoder_seq=cfg.encoder_seq)


#: The presets the three-step comparison holds (moments included): the
#: dense family and the VLM.  The other families' train steps are held
#: over two steps in tests/test_torch_families.py: their MoE expert
#: leaves get step-0 gradients of a few 1e-9, under AdamW's eps, whose
#: update turns on their last bits (ROADMAP.md section 3).
DENSE = [a for a in ARCH_IDS if get_config(a).family in ("dense", "vlm")]


@pytest.fixture(scope="module", params=DENSE)
def trained(request):
    """Three train steps of the reduced preset in both packages from the
    JAX weights: each step's metrics and trees."""
    jcfg = jget_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    js = jadamw_init(jp)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    ts = adamw_state_from_numpy(jax.tree.map(np.asarray, js))
    jstep = jax.jit(jbuild_train_step(jcfg, RULES,
                                      JRunConfig(attn_impl="ref"), lr=LR))
    tstep = steps.build_train_step(cfg, RunConfig("ref"), lr=LR)
    data, out = _data(cfg), []
    for step in range(3):
        b = data.batch_at(step)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        out.append(dict(
            jm={k: float(v) for k, v in jm.items()},
            tm={k: float(v) for k, v in tm.items()},
            jp=jax.tree.map(np.asarray, jp),
            tp={k: t.clone() for k, t in _flat(tp)},
            jms=jax.tree.map(np.asarray, js.m),
            tms={k: t.clone() for k, t in _flat(ts.m)},
            jvs=jax.tree.map(np.asarray, js.v),
            tvs={k: t.clone() for k, t in _flat(ts.v)}))
    return request.param, out


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_matches_jax(trained, n_steps):
    arch, out = trained
    r = out[n_steps - 1]
    assert r["tm"]["step"] == r["jm"]["step"] == n_steps
    assert abs(r["tm"]["loss"] - r["jm"]["loss"]) <= TOL_LOSS, arch
    assert abs(r["tm"]["grad_norm"] - r["jm"]["grad_norm"]) <= \
        TOL_GNORM * r["jm"]["grad_norm"], arch
    jp = dict(_flat(r["jp"]))
    assert sorted(r["tp"]) == sorted(jp)
    for k, t in r["tp"].items():
        assert t.shape == jp[k].shape and str(jp[k].dtype) == "float32"
        assert float(np.abs(t.numpy() - jp[k]).max()) <= TOL_PARAMS, (arch,
                                                                       k)
    assert _max_rel(r["tms"], dict(_flat(r["jms"]))) <= TOL_MOMENTS, arch
    assert _max_rel(r["tvs"], dict(_flat(r["jvs"]))) <= TOL_MOMENTS, arch


#: Whisper's cross-attention key bias ``bk_x`` has a zero gradient in
#: exact arithmetic (a bias added to every key shifts a row of scores by
#: one constant, which the softmax ignores): the measure below would read
#: two roundings of zero (~4e-12) against each other.  Its gradients are
#: held in tests/test_torch_families.py, that leaf absolutely.
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a != "whisper-large-v3"])
def test_gradients_land_on_the_stacked_leaves(arch):
    """`loss_and_grads` on the JAX weights: one gradient per leaf, stacked
    (L, ...) leaves included, of the leaf's shape and dtype, equal to
    jax.grad within 1e-5 of each leaf's largest magnitude."""
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    b = _data(cfg).batch_at(4)
    jl, jg = jax.value_and_grad(jbuild_loss_fn(
        jcfg, RULES, JRunConfig(attn_impl="ref")))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tg = steps.loss_and_grads(steps.build_loss_fn(cfg, RunConfig("ref")),
                                  tp, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
    assert not tl.requires_grad and abs(float(tl) - float(jl)) <= TOL_LOSS
    assert all(not t.requires_grad for _, t in _flat(tp))
    for (k, g), (_, p) in zip(_flat(tg), _flat(tp)):
        assert g.shape == p.shape and g.dtype == p.dtype, k
    assert tg["layers"]["norm1"].shape[0] == cfg.n_layers
    assert _max_rel(tg, dict(_flat(jax.tree.map(np.asarray, jg)))) <= 1e-5


def test_train_step_refuses_the_flash_kernel_and_unported_families():
    """The flash kernels have no backward.  (The MoE and the other
    families are ported now: their train steps run, held against JAX by
    the fixture above.)"""
    cfg = get_config("starcoder2-3b").reduced()
    with pytest.raises(ValueError, match="no backward"):
        steps.build_train_step(cfg, RunConfig("flash"))


# ---------------------------------------------------------------------------
# checkpoints: the JAX package's five unit tests, and both directions
# ---------------------------------------------------------------------------
def _ttree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 3, generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32)}}


def test_roundtrip(tmp_path):
    tree = _ttree()
    save_checkpoint(str(tmp_path), 7, {"params": tree}, extra={"note": "x"})
    path = latest_checkpoint(str(tmp_path))
    step, trees, extra = load_checkpoint(path)
    assert step == 7 and extra["note"] == "x"
    restored = restore_arrays(trees["params"], tree)
    for (_, a), (_, b) in zip(_flat(tree), _flat(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_retention_and_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, {"params": _ttree(s)}, keep_last=2)
    names = sorted(os.listdir(tmp_path))
    assert names == ["step_00000004", "step_00000005"]
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000005")


def test_async_save_visible_after_wait(tmp_path):
    save_checkpoint(str(tmp_path), 9, {"params": _ttree()}, async_save=True)
    wait_pending()
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000009")


def test_no_partial_checkpoint_visible(tmp_path):
    """tmp dirs are never picked up by latest_checkpoint."""
    os.makedirs(tmp_path / "step_00000003.tmp123")
    assert latest_checkpoint(str(tmp_path)) is None


def test_restore_casts_dtype(tmp_path):
    tree = {"w": torch.ones(3)}
    save_checkpoint(str(tmp_path), 1, {"params": tree})
    _, trees, _ = load_checkpoint(latest_checkpoint(str(tmp_path)))
    target = {"w": torch.zeros(3, dtype=torch.bfloat16)}
    restored = restore_arrays(trees["params"], target)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].float(), torch.ones(3))


def test_async_save_copies_before_the_update(tmp_path):
    """An async save holds the values of the call, not of a later in-place
    update (the trainer's optimizer updates in place)."""
    tree = {"w": torch.zeros(1000)}
    save_checkpoint(str(tmp_path), 1, {"params": tree}, async_save=True)
    tree["w"].add_(1.0)
    wait_pending()
    _, trees, _ = load_checkpoint(latest_checkpoint(str(tmp_path)))
    assert float(trees["params"]["w"].abs().max()) == 0.0


def _lm_trees(arch, seed, dtype=None):
    jcfg = jget_config(arch).reduced()
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jp, jadamw_init(jp)


def _same_checkpoint(a_dir, b_dir):
    """The two checkpoints hold the same manifest and, key by key, arrays
    of the same shape and bytes."""
    with open(Path(a_dir) / "manifest.json") as f:
        ma = json.load(f)
    with open(Path(b_dir) / "manifest.json") as f:
        mb = json.load(f)
    assert ma == mb
    with np.load(Path(a_dir) / "arrays.npz") as da, \
            np.load(Path(b_dir) / "arrays.npz") as db:
        assert list(da.keys()) == list(db.keys())
        for k in da.keys():
            assert da[k].shape == db[k].shape, k
            assert da[k].tobytes() == db[k].tobytes(), k
    return ma


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_checkpoints_cross_both_ways(tmp_path, dtype):
    """The same trained state saved by each package: the same files; the
    JAX checkpoint loads in the port and the port's in the JAX
    `load_checkpoint`."""
    jp, js = _lm_trees("starcoder2-3b", 0, dtype)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    ts = adamw_state_from_numpy(jax.tree.map(np.asarray, js))
    jsave(str(tmp_path / "jax"), 3, {"params": jp, "opt_state": js},
          extra={"k": 1})
    save_checkpoint(str(tmp_path / "port"), 3,
                    {"params": tp, "opt_state": ts}, extra={"k": 1})
    jdir, tdir = jlatest(str(tmp_path / "jax")), latest_checkpoint(
        str(tmp_path / "port"))
    man = _same_checkpoint(jdir, tdir)
    assert "layers/wqkv" in man["trees"]["params"]
    assert list(man["trees"]["opt_state"])[0] == "step"
    assert "m/layers/w_in" in man["trees"]["opt_state"]
    want = "bfloat16" if dtype else "float32"
    assert man["trees"]["params"]["layers/wqkv"]["dtype"] == want
    # JAX -> port: every leaf back with its dtype and bits
    step, trees, extra = load_checkpoint(jdir)
    assert step == 3 and extra == {"k": 1}
    params = restore_arrays(trees["params"], tp)
    state = restore_arrays(trees["opt_state"], ts)
    assert type(state).__name__ == "AdamWState" and int(state.step) == 0
    for (k, a), (_, b) in zip(_flat(params), _flat(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    # port -> JAX
    jstep, jtrees, _ = jload(tdir)
    assert jstep == 3
    jflat = dict(_flat(jax.tree.map(np.asarray, jp)))
    for k, a in jtrees["params"].items():
        assert a.tobytes() == jflat[k].tobytes(), k
    if dtype is None:
        back = jrestore(jtrees["opt_state"], js)
        assert int(back.step) == 0


def test_port_restores_bf16_the_jax_restore_rejects(tmp_path):
    """ROADMAP 3.5: the JAX `restore_arrays` cannot cast numpy's raw 2-byte
    array of a bf16 leaf back; the port restores it by the manifest."""
    jp, _ = _lm_trees("qwen1.5-4b", 2, "bfloat16")
    jsave(str(tmp_path), 1, {"params": jp})
    _, jtrees, _ = jload(jlatest(str(tmp_path)))
    with pytest.raises((ValueError, TypeError)):
        jrestore(jtrees["params"], jp)
    _, trees, _ = load_checkpoint(latest_checkpoint(str(tmp_path)))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    target = {k: ({n: torch.zeros_like(t) for n, t in v.items()}
                  if isinstance(v, dict) else torch.zeros_like(v))
              for k, v in tp.items()}
    got = restore_arrays(trees["params"], target)
    for (k, a), (_, b) in zip(_flat(got), _flat(tp)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), k


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _losses(out):
    return {line.split()[2]: line.split()[4] for line in out.splitlines()
            if line.startswith("[train] step")}


def test_fail_and_resume_reproduces_loss(tmp_path):
    """tests/test_checkpoint.py's protocol on the port at --device cpu:
    crash at step 12, resume, and the printed losses match the
    uninterrupted run's."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen1.5-4b", "--smoke", "--steps", "18", "--batch", "2",
            "--seq", "16", "--ckpt-every", "6", "--log-every", "1",
            "--device", "cpu"]

    ref = subprocess.run(base + ["--ckpt-dir", str(tmp_path / "ref")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr
    crash = subprocess.run(
        base + ["--ckpt-dir", str(tmp_path / "ft"), "--fail-at-step", "12"],
        env=env, capture_output=True, text=True, timeout=300)
    assert crash.returncode == 42, crash.stderr
    assert "INJECTED FAILURE at step 12" in crash.stdout
    # the exit waits for step 12's async save
    latest = latest_checkpoint(str(tmp_path / "ft"))
    start = int(latest[-8:])
    assert start == 12, latest
    resume = subprocess.run(
        base + ["--ckpt-dir", str(tmp_path / "ft"), "--resume"],
        env=env, capture_output=True, text=True, timeout=300)
    assert resume.returncode == 0, resume.stderr
    assert f"resumed from {latest} at step {start}" in resume.stdout

    ref_l, res_l = _losses(ref.stdout), _losses(resume.stdout)
    assert sorted(res_l, key=int) == [str(s) for s in range(start, 18)]
    for step in ("12", "15", "17"):
        assert ref_l[step] == res_l[step], (step, ref_l[step], res_l[step])
    assert ref.stdout.splitlines()[-1].startswith("[train] done: first loss")


@pytest.mark.parametrize("argv,err", [
    (["--mesh", "2"], ValueError),
    (["--mesh", "0x2", "--dp-mode", "pjit"], ValueError),
    (["--mesh", "4xm"], ValueError),
    (["--dp-mode", "gossip"], ValueError),
    (["--dp-mode", "gossip", "--mesh", "3x1"], ValueError),   # batch 8
])
def test_launcher_refuses_what_shards_the_model(argv, err):
    """What the launcher cannot run: a malformed mesh, gossip without a
    mesh or over a data axis the batch does not split over.  (The model
    is sharded now: ``--dp-mode pjit`` and ``--mesh DxM`` run, held in
    tests/test_torch_sharding.py.)"""
    with pytest.raises(err, match="ROADMAP|mesh|split"):
        train.main(["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu"]
                   + argv)


GOSSIP_ARGV = ["--arch", "starcoder2-3b", "--smoke", "--steps", "4",
               "--batch", "8", "--seq", "32", "--device", "cpu",
               "--log-every", "1"]


@pytest.fixture(scope="module")
def jax_plain_run(tmp_path_factory):
    """The JAX package's plain trainer (--dp-mode none) on the launcher's
    batches, from the JAX weights of seed 0, and those weights saved by
    the JAX package as a step-0 checkpoint for the port to resume from."""
    jcfg = jget_config("starcoder2-3b").reduced()
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    js = jadamw_init(jp)
    ckpt = tmp_path_factory.mktemp("jax_step0")
    jsave(str(ckpt), 0, {"params": jp, "opt_state": js})
    step = jax.jit(jbuild_train_step(jcfg, RULES,
                                     JRunConfig(attn_impl="ref"), lr=LR))
    data, losses = JData(vocab_size=jcfg.vocab_size, seq_len=32,
                         global_batch=8, seed=0), []
    for s in range(4):
        jp, js, m = step(jp, js, {k: jnp.asarray(v)
                                  for k, v in data.batch_at(s).items()})
        losses.append(float(m["loss"]))
    return str(ckpt), losses


@pytest.mark.parametrize("quantize,tol", [(False, 1e-5), (True, 5e-3)])
def test_gossip_on_four_ranks_matches_the_jax_plain_trainer(
        jax_plain_run, tmp_path, quantize, tol):
    """`--dp-mode gossip --mesh 4x1` on 4 gloo ranks, resumed from the JAX
    weights: rank 0's losses against the JAX plain trainer's on the same
    global batches; its checkpoint at step 4 loads in the JAX package."""
    ckpt, want = jax_plain_run
    run_dir = tmp_path / "run"
    shutil.copytree(ckpt, run_dir)
    argv = GOSSIP_ARGV + ["--dp-mode", "gossip", "--mesh", "4x1",
                          "--resume", "--ckpt-dir", str(run_dir)]
    if quantize:
        argv.append("--gossip-quantize")
    got = train.train(train.parse_args(argv))
    assert sorted(got["losses"]) == [0, 1, 2, 3]
    for s, w in enumerate(want):
        assert abs(got["losses"][s] - w) <= tol, (s, got["losses"][s], w)
    step, jtrees, _ = jload(jlatest(str(run_dir)))
    assert step == 4 and "layers/w_in" in jtrees["params"]


def test_gossip_injected_failure_exits_42(capfd):
    """An injected failure on the gossip ranks ends the launcher with the
    failure's exit code, as in one process."""
    with pytest.raises(SystemExit) as exc:
        train.main(GOSSIP_ARGV + ["--dp-mode", "gossip", "--mesh", "2x1",
                                  "--fail-at-step", "1"])
    assert exc.value.code == 42
    out = capfd.readouterr().out
    assert "[train] step     0" in out
    assert "INJECTED FAILURE at step 1" in out
