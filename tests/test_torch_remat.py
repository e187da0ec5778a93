"""The remat levers of the port's `RunConfig` (``remat`` none / full /
dots / named, ``attn_remat``, ``unroll_layers``), held three ways:

- every lever gives the loss and the gradients of ``remat="none"`` bit for
  bit (recomputing a block replays the same operations on the same
  inputs), for a dense preset, the MoE, MLA, RWKV6, hymba and whisper
  (its encoder runs under the same lever);
- the port's train step under a lever matches the JAX package's
  `build_train_step` under the same lever at tests/test_torch_train.py's
  tolerances (loss 1e-5, grad norm 1e-5 relative, parameters 2e-5
  absolute), one step at lr 1e-3 from the perturbed JAX weights
  (tests/_families.py);
- what autograd keeps from the forward: the tensors packed through
  `torch.autograd.graph.saved_tensors_hooks` outside the checkpointed
  blocks plus the outputs the selective policy saves inside them, per
  layer (the difference between 4 and 2 layers over 2): full < named <
  dots < none, and named keeps exactly its two tagged outputs.

One spawn of 4 gloo ranks runs the sharded step on a 2x2 ("data",
"model") mesh against the same sharded step without remat: under
``dots``, alone and with ``attn_remat`` (whose attention runs under
`local_map`), bit for bit; under ``named`` within the tolerances above,
as its tag copies a pending-sum DTensor, which changes the order of the
backward's sums.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.examples import spawn
from repro_torch.models import model, steps
from repro_torch.models import params as mparams
from repro_torch.models.model import REMAT_MODES, RunConfig
from repro_torch.tree import leaves, tree_map

sys.path.insert(0, str(Path(__file__).parent))

LR = 1e-3
TOL_LOSS, TOL_GNORM, TOL_PARAMS = 1e-5, 1e-5, 2e-5

#: One preset of each family the block dispatches on.
FAMILY_ARCHS = ["starcoder2-3b", "qwen3-moe-30b-a3b", "deepseek-v2-236b",
                "rwkv6-1.6b", "hymba-1.5b", "whisper-large-v3"]

#: The levers held against ``remat="none"`` (keyword arguments of
#: `RunConfig`).
LEVERS = {"full": dict(remat="full"), "dots": dict(remat="dots"),
          "named": dict(remat="named"),
          "attn_remat": dict(attn_remat=True),
          "dots+attn_remat": dict(remat="dots", attn_remat=True),
          "unroll_layers": dict(unroll_layers=True)}

#: The levers each preset is held to the JAX step under: every lever on
#: the dense preset, one lever on each other family.
JAX_CASES = ([("starcoder2-3b", k) for k in
              ("full", "dots", "named", "attn_remat")]
             + [("qwen3-moe-30b-a3b", "dots"), ("deepseek-v2-236b", "named"),
                ("rwkv6-1.6b", "full"), ("hymba-1.5b", "dots+attn_remat"),
                ("whisper-large-v3", "dots")])


def _data(cfg, batch=2, seq=16):
    return SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0,
        n_vision_tokens=cfg.n_vision_tokens if cfg.family == "vlm" else 0,
        d_model=cfg.d_model, encoder_seq=cfg.encoder_seq)


def _batch(cfg, step=0):
    return {k: torch.from_numpy(v)
            for k, v in _data(cfg).batch_at(step).items()}


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def test_run_config_fields_match_jax():
    """The JAX package's fields, defaults and order; an unknown remat
    mode raises."""
    from repro.models.model import RunConfig as JRunConfig

    ours = [(f.name, f.default) for f in dataclasses.fields(RunConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JRunConfig)]
    assert ours == ref
    for mode in REMAT_MODES:
        assert RunConfig(remat=mode).remat == mode
    with pytest.raises(ValueError, match="remat"):
        RunConfig(remat="everything")


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def no_remat(request):
    """A reduced preset's port weights (seed 0), a batch, and the loss and
    gradients without remat."""
    cfg = get_config(request.param).reduced()
    p = mparams.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    b = _batch(cfg)
    loss, g = steps.loss_and_grads(
        steps.build_loss_fn(cfg, RunConfig("ref")), p, b)
    return cfg, p, b, loss, g


@pytest.mark.parametrize("lever", list(LEVERS))
def test_lever_gives_the_bits_of_no_remat(no_remat, lever):
    cfg, p, b, loss, g = no_remat
    run = RunConfig("ref", **LEVERS[lever])
    got_loss, got = steps.loss_and_grads(steps.build_loss_fn(cfg, run), p, b)
    assert torch.equal(got_loss, loss), cfg.name
    want = dict(_flat(g))
    for k, t in _flat(got):
        assert torch.equal(t, want[k]), (cfg.name, lever, k)


@pytest.fixture(scope="module")
def jax_weights():
    """Perturbed JAX weights (seed 7) per preset, built once."""
    from repro.configs import get_config as jget_config

    from _families import perturbed_params

    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = perturbed_params(jget_config(arch).reduced(), 7)
        return cache[arch]

    return get


@pytest.mark.parametrize("arch,lever", JAX_CASES,
                         ids=[f"{a}-{k}" for a, k in JAX_CASES])
def test_step_under_lever_matches_jax(jax_weights, arch, lever):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.dist.sharding import ShardingRules
    from repro.models.model import RunConfig as JRunConfig
    from repro.models.steps import build_train_step as jbuild_train_step
    from repro.optim import adamw_init as jadamw_init
    from repro_torch.convert import adamw_state_from_numpy

    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jp, tp = jax_weights(arch)
    tp = tree_map(torch.clone, tp)
    js = jadamw_init(jp)
    ts = adamw_state_from_numpy(jax.tree.map(np.asarray, js))
    kw = LEVERS[lever]
    jstep = jax.jit(jbuild_train_step(
        jcfg, ShardingRules.null(), JRunConfig(attn_impl="ref", **kw),
        lr=LR))
    tstep = steps.build_train_step(cfg, RunConfig("ref", **kw), lr=LR)
    b = _data(cfg).batch_at(0)
    jp, _, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
    tp, _, tm = tstep(tp, ts, {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL_LOSS
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        TOL_GNORM * float(jm["grad_norm"])
    want = dict(_flat(jax.tree.map(np.asarray, jp)))
    for k, t in _flat(tp):
        assert float(np.abs(t.numpy() - want[k]).max()) <= TOL_PARAMS, k


def _kept(cfg, run, p, b):
    """(tensors packed outside the checkpointed blocks, outputs the
    selective policy saves inside them) over one forward."""
    from torch.utils.checkpoint import CheckpointPolicy

    n = {"packs": 0, "policy": 0}

    def count(policy):
        def counted(ctx, op, *args, **kwargs):
            out = policy(ctx, op, *args, **kwargs)
            if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                n["policy"] += 1
            return out
        return counted

    def pack(t):
        n["packs"] += 1
        return t

    orig = dict(model.POLICIES)
    model.POLICIES.update({k: count(f) for k, f in orig.items()})
    try:
        live = tree_map(lambda t: t.detach().requires_grad_(True), p)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = steps.build_loss_fn(cfg, run)(live, b)
        torch.autograd.grad(loss, leaves(live))
    finally:
        model.POLICIES.update(orig)
    return n["packs"], n["policy"]


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen3-moe-30b-a3b"])
def test_saved_tensors_per_layer_order_the_modes(arch):
    base = get_config(arch).reduced()
    per_layer = {}
    for mode in REMAT_MODES:
        counts = []
        for L in (2, 4):
            cfg = dataclasses.replace(base, n_layers=L)
            p = mparams.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
            counts.append(_kept(cfg, RunConfig("ref", remat=mode), p,
                                _batch(cfg)))
        per_layer[mode] = tuple((b - a) / 2 for a, b in zip(*counts))
    total = {m: sum(v) for m, v in per_layer.items()}
    assert total["full"] < total["named"] < total["dots"] < total["none"], \
        per_layer
    # named keeps the block's input (as full does) and its two tags
    assert per_layer["named"] == (per_layer["full"][0], 2), per_layer
    assert per_layer["none"][1] == per_layer["full"][1] == 0


# ---------------------------------------------------------------------------
# the sharded step on 2x2 gloo ranks
# ---------------------------------------------------------------------------
SHARDED_LEVERS = {"dots": dict(remat="dots"),
                  "dots+attn_remat": dict(remat="dots", attn_remat=True),
                  "named": dict(remat="named")}


def _sharded_case():
    """On every rank: the sharded starcoder2-3b step (reduced, B 4, S 16,
    default scheme) without remat and under each of SHARDED_LEVERS, from
    the same weights; the loss, grad norm and the full parameters after
    one step."""
    from repro_torch.dist.sharding import full, make_rules
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import adamw_init

    mesh = make_test_mesh((2, 2))
    rules = make_rules(mesh, "default")
    cfg = get_config("starcoder2-3b").reduced()
    init = mparams.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=16,
                           global_batch=4, seed=0)
    b = steps.distribute_batch({k: torch.from_numpy(v) for k, v in
                                data.batch_at(0).items()}, rules)
    out = {}
    for label, kw in [("none", {})] + list(SHARDED_LEVERS.items()):
        p = mparams.distribute_params(tree_map(torch.clone, init),
                                      mparams.param_pspecs(cfg, rules), mesh)
        step = steps.build_train_step(cfg, RunConfig("ref", **kw), lr=LR,
                                      rules=rules)
        p, _, m = step(p, adamw_init(p), b)
        out[label] = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "params": {k: full(t).numpy() for k, t in _flat(p)}}
    return out


@pytest.fixture(scope="module")
def sharded():
    return spawn(_sharded_case, 4)


@pytest.mark.parametrize("lever", ["dots", "dots+attn_remat"])
def test_sharded_step_under_lever_gives_the_bits_of_no_remat(sharded,
                                                             lever):
    want, got = sharded["none"], sharded[lever]
    assert got["loss"] == want["loss"]
    assert got["grad_norm"] == want["grad_norm"]
    for k, v in got["params"].items():
        assert np.array_equal(v, want["params"][k]), k


def test_sharded_step_under_named_matches_no_remat(sharded):
    want, got = sharded["none"], sharded["named"]
    assert abs(got["loss"] - want["loss"]) <= TOL_LOSS
    assert abs(got["grad_norm"] - want["grad_norm"]) <= \
        TOL_GNORM * want["grad_norm"]
    for k, v in got["params"].items():
        assert float(np.abs(v - want["params"][k]).max()) <= TOL_PARAMS, k
