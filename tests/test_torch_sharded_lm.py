"""The sharded LM train step (`build_train_step(..., rules=rules)` on a
("data", "model") DeviceMesh) held against the JAX package's sharded step
and against the port's unsharded step.

One spawn of 4 gloo ranks on a 2x2 mesh runs every case; meanwhile the
JAX package's step runs in a subprocess with 4 forced host devices (the
environment of `tests/_subproc.py`) on `make_test_mesh((2, 2))` (the JAX
launcher's own mesh fails under jax 0.9.0: ROADMAP.md section 3, item
10).  Both start from the same
weights: the JAX init of PRNGKey(0) with its zero and one leaves
perturbed (tests/_families.py), carried across with
`lm_params_from_numpy`.  Two steps at lr 1e-3 on `SyntheticLMData`
seed 0, B 4, S 16, each held to tests/test_torch_train.py's tolerances:
loss 1e-5, grad norm 1e-5 relative, parameters 2e-5 absolute, and the
step-0 gradients within 1e-5 of each leaf's largest magnitude
(tests/test_torch_families.py's; a leaf that is zero in exact
arithmetic, whisper's ``bk_x``, within 1e-9 of zero).

A parameter whose gradient at a step of the unsharded run is nonzero,
under AdamW's eps (1e-8) and within the gradient tolerance of zero (1e-5
of its leaf's largest magnitude) is ill-conditioned: its update
lr g / (|g| + eps) turns on bits of g that no tolerance here fixes
(ROADMAP.md section 3, items 8 and 11; one element of qwen2-vl's
``w_down`` has a step-0 gradient of 2.1e-10 against the leaf's 7.8e-3
and moves 2.4e-5 apart from the unsharded step; the key part of
``bqkv`` is zero in exact arithmetic).  Such elements are held through
their gradients instead of their values.

Cases: starcoder2-3b and qwen3-moe-30b-a3b (grouped dispatch, 2 groups)
under the ``default`` and ``fsdp`` schemes; deepseek-v2 (MLA and the
global-sort MoE), rwkv6, hymba, whisper and qwen2-vl under ``default``.
The JAX package is imported only inside the fixture: the ranks import
this module to find their entry point.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.examples import spawn

ROOT = Path(__file__).resolve().parents[1]
WORLD, STEPS, BATCH, SEQ, LR = 4, 2, 4, 16, 1e-3
TOL_LOSS, TOL_GNORM, TOL_PARAMS, TOL_GRADS = 1e-5, 1e-5, 2e-5, 1e-5
ADAM_EPS = 1e-8
#: A gradient leaf no larger than this is zero in exact arithmetic.
ZERO_LEAF = 1e-9

#: (preset, scheme, MoE dispatch)
CASES = [("starcoder2-3b", "default", "global_sort"),
         ("starcoder2-3b", "fsdp", "global_sort"),
         ("qwen3-moe-30b-a3b", "default", "grouped"),
         ("qwen3-moe-30b-a3b", "fsdp", "grouped"),
         ("deepseek-v2-236b", "default", "global_sort"),
         ("rwkv6-1.6b", "default", "global_sort"),
         ("hymba-1.5b", "default", "global_sort"),
         ("whisper-large-v3", "default", "global_sort"),
         ("qwen2-vl-2b", "default", "global_sort")]
IDS = [f"{a}-{s}" for a, s, _ in CASES]

#: The JAX package's sharded step on 4 forced host devices: reads each
#: case's weights from <dir>/init_<i>.npz, writes <dir>/jax_<i>.npz (the
#: parameters after STEPS steps) and <dir>/jax.json (the metrics).
_JAX = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.data import SyntheticLMData
from repro.dist.sharding import make_rules
from repro.launch.mesh import make_test_mesh
from repro.models.model import RunConfig
from repro.models.steps import build_train_step
from repro.optim import adamw_init

out, cases = sys.argv[1], json.loads(sys.argv[2])
steps, batch, seq, lr = (int(sys.argv[3]), int(sys.argv[4]),
                         int(sys.argv[5]), float(sys.argv[6]))
mesh = make_test_mesh((2, 2))


def nest(flat):
    tree = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return tree


metrics = []
for i, (arch, scheme, disp) in enumerate(cases):
    cfg = get_config(arch).reduced()
    with np.load(f"{out}/init_{i}.npz") as f:
        p = nest(dict(f))
    s = adamw_init(p)
    step = jax.jit(build_train_step(
        cfg, make_rules(mesh, scheme),
        RunConfig(attn_impl="ref", moe_dispatch=disp, moe_groups=2), lr=lr))
    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0,
        n_vision_tokens=cfg.n_vision_tokens if cfg.family == "vlm" else 0,
        d_model=cfg.d_model, encoder_seq=cfg.encoder_seq)
    m = []
    for t in range(steps):
        p, s, mt = step(p, s, {k: jnp.asarray(v)
                               for k, v in data.batch_at(t).items()})
        m.append([float(mt["loss"]), float(mt["grad_norm"])])
    metrics.append(m)
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(p)[0]}
    np.savez(f"{out}/jax_{i}.npz", **flat)
with open(f"{out}/jax.json", "w") as f:
    json.dump(metrics, f)
"""


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _nest(flat):
    tree = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _run_cases(tmp: str):
    """Every case on this rank of the 2x2 mesh: STEPS sharded and STEPS
    unsharded steps from the same weights.  Returns (on every rank) the
    metrics, the final parameters of both (host numpy), which elements
    had an ill-conditioned unsharded gradient at a step (module doc), each
    leaf's step-0 gradient error and largest magnitude, and whether every parameter and moment kept its `param_pspecs`
    layout (AdamW refuses a gradient in another layout)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.data import SyntheticLMData
    from repro_torch.dist.sharding import full, make_rules
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import params as mparams
    from repro_torch.models import steps
    from repro_torch.models.model import RunConfig
    from repro_torch.optim import adamw_init
    from repro_torch.tree import leaves

    mesh = make_test_mesh((2, 2))
    out = []
    for i, (arch, scheme, disp) in enumerate(CASES):
        cfg = get_config(arch).reduced()
        run = RunConfig("ref", moe_dispatch=disp, moe_groups=2)
        rules = make_rules(mesh, scheme)
        with np.load(os.path.join(tmp, f"init_{i}.npz")) as f:
            init = _nest(dict(f))
        plain = lm_params_from_numpy(init)
        sharded = mparams.distribute_params(
            lm_params_from_numpy(init), mparams.param_pspecs(cfg, rules),
            mesh)
        want = [rules.placements(*m.axes)
                for m in leaves(mparams.abstract_params(cfg))]
        sp, ss = adamw_init(plain), adamw_init(sharded)
        step_p = steps.build_train_step(cfg, run, lr=LR)
        step_s = steps.build_train_step(cfg, run, lr=LR, rules=rules)
        loss_p = steps.build_loss_fn(cfg, run)
        loss_s = steps.build_loss_fn(cfg, run, rules)
        data = SyntheticLMData(
            vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
            seed=0,
            n_vision_tokens=cfg.n_vision_tokens if cfg.family == "vlm"
            else 0, d_model=cfg.d_model, encoder_seq=cfg.encoder_seq)
        rec = {"plain": [], "sharded": []}
        tiny = {}
        for t in range(STEPS):
            b = {k: torch.from_numpy(v) for k, v in data.batch_at(t).items()}
            db = steps.distribute_batch(b, rules)
            _, g = steps.loss_and_grads(loss_p, plain, b)
            for k, gk in _flat(g):
                a = gk.abs()
                small = ((a != 0) & (a < ADAM_EPS)
                         & (a <= TOL_GRADS * a.max())).numpy()
                tiny[k] = tiny.get(k, False) | small
            if t == 0:
                _, gs = steps.loss_and_grads(loss_s, sharded, db)
                gs = dict(_flat(gs))
                rec["grad"] = {k: (float((full(gs[k]) - gk).abs().max()),
                                   float(gk.abs().max()))
                               for k, gk in _flat(g)}
            plain, sp, mp_ = step_p(plain, sp, b)
            sharded, ss, ms = step_s(sharded, ss, db)
            rec["plain"].append([float(mp_["loss"]), float(mp_["grad_norm"])])
            rec["sharded"].append([float(ms["loss"]), float(ms["grad_norm"])])
        layout = all(
            [tuple(t.placements) for t in leaves(tree)] == want
            for tree in (sharded, ss.m, ss.v))
        rec["layout"] = layout
        rec["tiny"] = tiny
        rec["plain_params"] = {k: t.numpy() for k, t in _flat(plain)}
        rec["sharded_params"] = {k: full(t).numpy()
                                 for k, t in _flat(sharded)}
        out.append(rec)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both packages on every case: the JAX payload in a subprocess and
    the port's 4 ranks at the same time."""
    import jax

    from repro.configs import get_config as jget_config

    sys.path.insert(0, str(Path(__file__).parent))
    from _families import perturbed_params

    tmp = tmp_path_factory.mktemp("sharded_lm")
    for i, (arch, _, _) in enumerate(CASES):
        jp, _ = perturbed_params(jget_config(arch).reduced(), 0)
        np.savez(tmp / f"init_{i}.npz",
                 **dict(_flat(jax.tree.map(np.asarray, jp))))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", _JAX, str(tmp), json.dumps(CASES),
         str(STEPS), str(BATCH), str(SEQ), str(LR)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = spawn(_run_cases, WORLD, str(tmp))
        _, err = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert ref.returncode == 0, err
    with open(tmp / "jax.json") as f:
        jmetrics = json.load(f)
    jparams = []
    for i in range(len(CASES)):
        with np.load(tmp / f"jax_{i}.npz") as f:
            jparams.append(dict(f))
    return port, jmetrics, jparams


def _close_params(got, want, rec, tol):
    """Every element within `tol` but the ill-conditioned ones, which the
    gradient check holds."""
    tiny = rec["tiny"]
    assert sorted(got) == sorted(want)
    worst = max((float(np.where(tiny[k], 0.0, np.abs(got[k] - want[k])).max()),
                 k) for k in got)
    assert worst[0] <= tol, worst


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_sharded_step_matches_the_jax_sharded_step(results, i):
    port, jmetrics, jparams = results
    rec = port[i]
    for (loss, gn), (jloss, jgn) in zip(rec["sharded"], jmetrics[i]):
        assert abs(loss - jloss) <= TOL_LOSS, (loss, jloss)
        assert abs(gn - jgn) <= TOL_GNORM * jgn, (gn, jgn)
    _close_params(rec["sharded_params"], jparams[i], rec, TOL_PARAMS)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_sharded_step_matches_the_unsharded_step(results, i):
    """...and keeps every parameter, gradient and moment in its
    `param_pspecs` layout; its step-0 gradients equal the unsharded
    ones."""
    port, _, _ = results
    rec = port[i]
    assert rec["layout"]
    for k, (err, top) in rec["grad"].items():
        assert err <= (ZERO_LEAF if top <= ZERO_LEAF else TOL_GRADS * top), (
            k, err, top)
    for (loss, gn), (ploss, pgn) in zip(rec["sharded"], rec["plain"]):
        assert abs(loss - ploss) <= TOL_LOSS, (loss, ploss)
        assert abs(gn - pgn) <= TOL_GNORM * pgn, (gn, pgn)
    _close_params(rec["sharded_params"], rec["plain_params"], rec,
                  TOL_PARAMS)
