"""The MoE, MLA, RWKV6, hymba and whisper families of the port, held
against the JAX package on the same numpy inputs and weights (the JAX
trees carried across with `convert.lm_params_from_numpy`, their zero and
one leaves perturbed first: tests/_families.py).

Tolerances (float32, the reduced presets):

- the configs, the shape specs and the parameter metadata: equal;
- the layer primitives (token shift, group norm, the sinusoidal
  positions, the shared expert): 1e-6 (the same f32 arithmetic); the
  channel mix 1e-5 (XLA's sigmoid is another f32 formula: 2.9e-6 apart on
  outputs of magnitude 1);
- `moe_ffn` / `moe_ffn_grouped`: the expert picks equal, outputs 1e-5
  (the combine sums a token's k outputs in another order);
- `time_mix`, `channel_mix`, `ssm_branch`: outputs and states 1e-5;
- the forward: logits 1e-4 with ``attn_impl`` "ref" and "chunked"
  (tests/test_torch_lm.py's tolerance);
- two train steps at lr 1e-3: loss 1e-5, params 2e-5
  (tests/test_torch_train.py's tolerances); gradients 1e-5 of each leaf's largest magnitude, and
  whisper's cross-attention key bias, whose gradient is zero in exact
  arithmetic, within 1e-9 of zero;
- `init_params`: the presets the card already draws (the dense presets
  and the VLM backbone) draw the same values as the whole-leaf rule
  before the slice-wise draw came in.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _families import FAMILIES, frames, perturbed_params
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import shape_applicable as jshape_applicable
from repro.dist.sharding import ShardingRules
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import rwkv6 as jrwkv6
from repro.models.model import RunConfig as JRunConfig
from repro.models.model import encode as jencode
from repro.models.model import forward as jforward
from repro.models.steps import build_loss_fn as jbuild_loss_fn
from repro.models.steps import build_train_step as jbuild_train_step
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeSpec, get_config,
                                 shape_applicable)
from repro_torch.convert import adamw_state_from_numpy
from repro_torch.models import layers, mamba, moe, params, rwkv6, steps
from repro_torch.models.model import RunConfig, encode, forward
from repro_torch.tree import leaves

RULES = ShardingRules.null()
B, S = 2, 12


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               atol=atol, rtol=0)


def _randn(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


# ---------------------------------------------------------------------------
# configs and shape specs
# ---------------------------------------------------------------------------
def test_registry_and_shape_specs_match_jax():
    assert ARCH_IDS == JARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for arch in ARCH_IDS:
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                jshape_applicable(jget_config(arch), JSHAPES[name])
    assert ShapeSpec("x", 1, 1, "decode").is_decode
    subq = [a for a in ARCH_IDS if get_config(a).sub_quadratic]
    assert subq == ["rwkv6-1.6b", "hymba-1.5b"]


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_jax(arch, reduced):
    cfg, jcfg = get_config(arch), jget_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.param_count(active_only=True) == \
        jcfg.param_count(active_only=True)


def test_reduced_family_fields():
    """The reduced sizes the JAX tests run at, spelled out."""
    assert get_config("deepseek-v2-236b").reduced().rope_head_dim == 8
    assert get_config("whisper-large-v3").reduced().encoder_seq == 24
    assert get_config("qwen2-vl-2b").reduced().mrope_sections == (2, 3, 3)
    moe_cfg = get_config("qwen3-moe-30b-a3b").reduced()
    assert (moe_cfg.n_experts, moe_cfg.top_k) == (4, 2)
    assert get_config("hymba-1.5b").reduced().sliding_window == 32


# ---------------------------------------------------------------------------
# layer primitives
# ---------------------------------------------------------------------------
def test_sinusoidal_positions_interleave_and_match_jax():
    pos = np.array([[0, 3, 17], [5, 1500, 2]])
    want = jlayers.sinusoidal_at(jnp.asarray(pos), 64)
    got = layers.sinusoidal_at(torch.from_numpy(pos), 64)
    assert got.shape == (2, 3, 64) and got.dtype == torch.float32
    _close(got, want, 1e-6)
    # sin at the even columns, cos at the odd ones
    _close(got[..., 0], np.sin(pos), 1e-6)
    _close(got[..., 1], np.cos(pos), 1e-6)
    _close(layers.sinusoidal_positions(24, 64),
           jlayers.sinusoidal_positions(24, 64), 1e-6)


def test_group_norm_heads_matches_jax():
    x, scale = _randn(0, 2, 5, 4, 16, scale=3.0), _randn(1, 4, 16)
    (jx, js), (tx, ts) = _both(x, scale)
    _close(layers.group_norm_heads(tx, ts), jlayers.group_norm_heads(jx, js),
           1e-6)


@pytest.mark.parametrize("last", [False, True])
def test_token_shift_matches_jax(last):
    x, prev = _randn(2, 2, 5, 8), _randn(3, 2, 8)
    (jx, jp), (tx, tp) = _both(x, prev)
    got = layers.token_shift(tx, tp if last else None)
    _close(got, jlayers.token_shift(jx, jp if last else None), 0)
    _close(got[:, 1:], x[:, :-1], 0)


def test_rwkv_channel_mix_matches_jax():
    arrays = (_randn(4, 2, 5, 8), _randn(5, 2, 5, 8), _randn(6, 8),
              _randn(7, 8), _randn(8, 8, 16, scale=0.3),
              _randn(9, 16, 8, scale=0.3), _randn(10, 8, 8, scale=0.3))
    js, ts = _both(*arrays)
    _close(layers.rwkv_channel_mix(*ts), jlayers.rwkv_channel_mix(*js), 1e-5)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def _moe_inputs(seed, T=64, d=32, E=8, F=16):
    return (_randn(seed, T, d), _randn(seed + 1, d, E),
            _randn(seed + 2, E, d, F, scale=0.2),
            _randn(seed + 3, E, d, F, scale=0.2),
            _randn(seed + 4, E, F, d, scale=0.2))


@pytest.mark.parametrize("T,d,E,k", [(64, 32, 8, 2), (48, 16, 4, 1),
                                     (40, 32, 16, 6)])
@pytest.mark.parametrize("cf", [1.0, 1.25, 4.0])
@pytest.mark.parametrize("groups", [0, 1, 4])
def test_moe_matches_jax(T, d, E, k, cf, groups):
    """groups 0: `moe_ffn`; else `moe_ffn_grouped` with that many groups.
    At capacity factors 1.0 and 1.25 assignments drop; the expert picks
    are equal and so are the outputs, dropped assignments included."""
    x, router, wg, wu, wd = _moe_inputs(T + E + k, T, d, E, 16)
    js, ts = _both(x, router, wg, wu, wd)
    jlogits = js[0] @ js[1]
    _, jidx = jax.lax.top_k(jlogits.reshape(-1, E), k)
    _, tidx = moe.route(ts[0], ts[1], k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    if groups:
        want = jmoe.moe_ffn_grouped(*js, top_k=k, capacity_factor=cf,
                                    n_groups=groups)
        got = moe.moe_ffn_grouped(*ts, top_k=k, capacity_factor=cf,
                                  n_groups=groups)
    else:
        want = jmoe.moe_ffn(*js, top_k=k, capacity_factor=cf)
        got = moe.moe_ffn(*ts, top_k=k, capacity_factor=cf)
    assert got.shape == (T, d)
    _close(got, want, 1e-5)


def test_moe_drops_past_capacity():
    """At capacity factor 1.0 some expert is over capacity on these
    inputs: its late assignments add nothing, as in the JAX package, and
    raising the capacity changes the output."""
    x, router, wg, wu, wd = map(torch.from_numpy, _moe_inputs(3))
    _, idx = moe.route(x, router, 2)
    C = moe.capacity(64, 8, 2, 1.0)
    assert int(torch.bincount(idx.flatten(), minlength=8).max()) > C
    tight = moe.moe_ffn(x, router, wg, wu, wd, top_k=2, capacity_factor=1.0)
    roomy = moe.moe_ffn(x, router, wg, wu, wd, top_k=2, capacity_factor=4.0)
    assert float((tight - roomy).abs().max()) > 1e-3


def test_moe_route_breaks_ties_to_the_lower_expert():
    """Equal logits pick the lower expert id first, as jax.lax.top_k."""
    logits = np.array([[1.0, 3.0, 3.0, 0.5, 3.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    x = torch.eye(2)
    router = torch.from_numpy(logits)
    _, idx = moe.route(x, router, 3)
    _, jidx = jax.lax.top_k(jnp.asarray(logits), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]


@pytest.mark.parametrize("T,E,k,cf", [(24, 4, 2, 1.25), (2, 128, 8, 1.25),
                                      (2048, 128, 8, 1.25),
                                      (192, 160, 6, 160 / 6),
                                      (7, 4, 2, 2.0)])
def test_capacity_matches_jax(T, E, k, cf):
    assert moe.capacity(T, E, k, cf) == jmoe.capacity(T, E, k, cf)


def test_grouped_dispatch_refuses_rules_and_uneven_groups():
    """Rules without a mesh (the null rules) are the plain dispatch, bit
    for bit (the sharded dispatch is held in
    tests/test_torch_sharded_lm.py); uneven groups are refused."""
    from repro_torch.dist.sharding import ShardingRules

    x, router, wg, wu, wd = map(torch.from_numpy, _moe_inputs(5))
    kw = dict(top_k=2, n_groups=2)
    plain = moe.moe_ffn_grouped(x[:24], router, wg, wu, wd, **kw)
    assert torch.equal(plain, moe.moe_ffn_grouped(
        x[:24], router, wg, wu, wd, rules=ShardingRules.null(), **kw))
    with pytest.raises(ValueError, match="groups"):
        moe.moe_ffn_grouped(x, router, wg, wu, wd, top_k=2, n_groups=5)


def test_shared_expert_matches_jax():
    arrays = (_randn(11, 2, 5, 16), _randn(12, 16, 24, scale=0.25),
              _randn(13, 16, 24, scale=0.25), _randn(14, 24, 16, scale=0.25))
    (jx, *jw), (tx, *tw) = _both(*arrays)
    names = ("ws_gate", "ws_up", "ws_down")
    _close(moe.shared_expert_ffn(tx, dict(zip(names, tw))),
           jmoe.shared_expert_ffn(jx, dict(zip(names, jw))), 1e-6)


# ---------------------------------------------------------------------------
# RWKV6 and the mamba branch, layer 0 of the perturbed reduced presets
# ---------------------------------------------------------------------------
def _layer0(arch, seed):
    jcfg = jget_config(arch).reduced()
    jp, tp = perturbed_params(jcfg, seed)
    jl = {k: v[0] for k, v in jp["layers"].items()}
    tl = {k: v[0] for k, v in tp["layers"].items()}
    return jcfg, jl, tl


@pytest.mark.parametrize("seq", [1, 9])
def test_rwkv_time_and_channel_mix_match_jax(seq):
    """From a nonzero state (wkv, shift and cm_shift drawn), S = 1 (a
    decode step) and 9."""
    cfg, jl, tl = _layer0("rwkv6-1.6b", 20)
    H, hd, D = cfg.n_heads, cfg.hd, cfg.d_model
    x, wkv, shift, cm = (_randn(21, B, seq, D), _randn(22, B, H, hd, hd),
                         _randn(23, B, D), _randn(24, B, D))
    (jx, jwkv, jshift, jcm), (tx, twkv, tshift, tcm) = _both(x, wkv, shift,
                                                             cm)
    jy, (jw, js) = jrwkv6.time_mix(jx, jl, (jwkv, jshift), H)
    ty, (tw, ts) = rwkv6.time_mix(tx, tl, (twkv, tshift), H)
    _close(ty, jy, 1e-5)
    _close(tw, jw, 1e-5)
    _close(ts, js, 0)
    assert tw.dtype == torch.float32
    jy, js = jrwkv6.channel_mix(jx, jl, jcm)
    ty, ts = rwkv6.channel_mix(tx, tl, tcm)
    _close(ty, jy, 1e-5)
    _close(ts, js, 0)


@pytest.mark.parametrize("seq", [1, 9])
def test_ssm_branch_matches_jax(seq):
    """From a nonzero state (h and the convolution tail drawn)."""
    cfg, jl, tl = _layer0("hymba-1.5b", 25)
    d_in = cfg.ssm_expand * cfg.d_model
    x, h, tail = (_randn(26, B, seq, cfg.d_model),
                  _randn(27, B, d_in, cfg.ssm_state),
                  _randn(28, B, cfg.conv_width - 1, d_in))
    (jx, jh, jt), (tx, th, tt) = _both(x, h, tail)
    jy, (jh2, jt2) = jmamba.ssm_branch(jx, jl, (jh, jt), cfg.ssm_state)
    ty, (th2, tt2) = mamba.ssm_branch(tx, tl, (th, tt), cfg.ssm_state)
    _close(ty, jy, 1e-5)
    _close(th2, jh2, 1e-5)
    _close(tt2, jt2, 1e-6)


def test_causal_conv_tail_is_the_last_inputs():
    x, w, b, tail = (_randn(30, 2, 5, 6), _randn(31, 4, 6), _randn(32, 6),
                     _randn(33, 2, 3, 6))
    js, ts = _both(x, w, b, tail)
    got, new_tail = mamba._causal_conv(*ts)
    want, jtail = jmamba._causal_conv(*js)
    _close(got, want, 1e-6)
    _close(new_tail, x[:, -3:], 0)
    _close(new_tail, jtail, 0)


def test_state_inits_match_jax():
    for arch, port, ref in (("rwkv6-1.6b", rwkv6, jrwkv6),
                            ("hymba-1.5b", mamba, jmamba)):
        cfg = get_config(arch)
        got = port.init_state(cfg, 3, torch.bfloat16, "cpu")
        want = ref.init_state(jget_config(arch), 3, jnp.bfloat16)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in want.items()}


# ---------------------------------------------------------------------------
# the forward, the encoder and the train step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """A reduced family preset (f32), its perturbed JAX weights and the
    same weights in the port."""
    jcfg = jget_config(request.param).reduced()
    jp, tp = perturbed_params(jcfg, 1)
    return jcfg, get_config(request.param).reduced(), jp, tp


@pytest.mark.parametrize("impl", ["ref", "chunked"])
def test_forward_matches_jax(family, impl):
    """B 2, S 12 (chunk 4: the chunked loop runs); the config's own MoE
    capacity factor, so the MoE drops assignments as the JAX forward
    does."""
    jcfg, cfg, jp, tp = family
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (B, S))
    jfr, tfr = frames(cfg, 3, B)
    want = jforward(jcfg, jp, jnp.asarray(toks), RULES,
                    JRunConfig(attn_impl=impl, attn_chunk=4), **jfr)
    got = forward(cfg, tp, torch.from_numpy(toks),
                  RunConfig(impl, attn_chunk=4), **tfr)
    assert got.shape == (B, S, cfg.vocab_size)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "qwen3-moe-30b-a3b"])
def test_grouped_dispatch_forward_matches_jax(arch):
    """The MoE presets with ``moe_dispatch="grouped"`` over 2 groups."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jp, tp = perturbed_params(jcfg, 8)
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size, (B, S))
    want = jforward(jcfg, jp, jnp.asarray(toks), RULES,
                    JRunConfig(attn_impl="ref", moe_dispatch="grouped",
                               moe_groups=2))
    got = forward(cfg, tp, torch.from_numpy(toks),
                  RunConfig("ref", moe_dispatch="grouped", moe_groups=2))
    _close(got, want, 1e-4)


def test_whisper_encoder_and_its_frames():
    jcfg = jget_config("whisper-large-v3").reduced()
    cfg = get_config("whisper-large-v3").reduced()
    jp, tp = perturbed_params(jcfg, 5)
    jfr, tfr = frames(cfg, 6, B)
    _close(encode(cfg, tp, tfr["encoder_frames"]),
           jencode(jcfg, jp, jfr["encoder_frames"], RULES,
                   JRunConfig(attn_impl="ref")), 1e-5)
    with pytest.raises(ValueError, match="encoder frames"):
        forward(cfg, tp, torch.zeros(1, 4, dtype=torch.long))


@pytest.fixture(scope="module", params=FAMILIES)
def trained_family(request):
    """Two train steps at lr 1e-3 in both packages from the perturbed JAX
    weights, on `SyntheticLMData`'s batches (with whisper's frames)."""
    from repro_torch.data import SyntheticLMData

    jcfg = jget_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp, tp = perturbed_params(jcfg, 7)
    js = jadamw_init(jp)
    ts = adamw_state_from_numpy(jax.tree.map(np.asarray, js))
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=16,
                           global_batch=2, seed=0, d_model=cfg.d_model,
                           encoder_seq=cfg.encoder_seq)
    b0 = data.batch_at(0)
    _, jg = jax.value_and_grad(jbuild_loss_fn(
        jcfg, RULES, JRunConfig(attn_impl="ref")))(
        jp, {k: jnp.asarray(v) for k, v in b0.items()})
    _, tg = steps.loss_and_grads(steps.build_loss_fn(cfg, RunConfig("ref")),
                                 tp, {k: torch.from_numpy(v)
                                      for k, v in b0.items()})
    jstep = jax.jit(jbuild_train_step(jcfg, RULES,
                                      JRunConfig(attn_impl="ref"), lr=1e-3))
    tstep = steps.build_train_step(cfg, RunConfig("ref"), lr=1e-3)
    metrics = []
    for step in range(2):
        b = data.batch_at(step)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        metrics.append(({k: float(v) for k, v in jm.items()},
                        {k: float(v) for k, v in tm.items()}))
    return cfg, metrics, jax.tree.map(np.asarray, jp), tp, \
        jax.tree.map(np.asarray, jg), tg


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def test_two_train_steps_match_jax(trained_family):
    cfg, metrics, jp, tp, _, _ = trained_family
    for jm, tm in metrics:
        assert tm["step"] == jm["step"]
        assert abs(tm["loss"] - jm["loss"]) <= 1e-5
        assert abs(tm["grad_norm"] - jm["grad_norm"]) <= \
            1e-5 * jm["grad_norm"]
    want = dict(_flat(jp))
    got = dict(_flat(tp))
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.shape == want[k].shape, k
        assert float(np.abs(t.numpy() - want[k]).max()) <= 2e-5, k


def test_gradients_match_jax(trained_family):
    cfg, _, _, _, jg, tg = trained_family
    want = dict(_flat(jg))
    for k, g in _flat(tg):
        w = want[k]
        err = float(np.abs(g.numpy() - w).max())
        if k == "layers/bk_x":
            # zero in exact arithmetic: the softmax ignores a shift of
            # every key by the same bias
            assert err <= 1e-9 and float(np.abs(w).max()) <= 1e-9, k
        else:
            assert err <= 1e-5 * float(np.abs(w).max()), k


# ---------------------------------------------------------------------------
# init_params: the slice-wise draw
# ---------------------------------------------------------------------------
def _whole_leaf_init(cfg, generator, dtype=None):
    """The rule `init_params` had before the slice-wise draw: every normal
    leaf drawn whole in f32, then cast."""
    from repro_torch.tree import tree_map

    dtype = dtype or cfg.torch_dtype

    def draw(meta):
        if meta.init == "zeros":
            return torch.zeros(meta.shape, dtype=dtype)
        if meta.init == "ones":
            return torch.ones(meta.shape, dtype=dtype)
        leaf = torch.randn(meta.shape, generator=generator,
                           dtype=torch.float32)
        return leaf.mul_(meta.scale).to(dtype)

    return tree_map(draw, params.abstract_params(cfg))


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a not in FAMILIES])
def test_init_params_draws_as_before(arch):
    cfg = get_config(arch).reduced()
    got = params.init_params(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
    want = _whole_leaf_init(cfg, torch.Generator().manual_seed(3))
    assert dict(_flat(got)).keys() == dict(_flat(want)).keys()
    for (k, a), (_, b) in zip(_flat(got), _flat(want)):
        assert torch.equal(a, b), k


def test_full_presets_the_card_draws_take_the_whole_leaf_route():
    """starcoder2-3b's largest leaf (w_in, 1.13e9) and qwen2-vl-2b's stay
    under the threshold (so their draws are the whole-leaf rule's); the
    expert leaves of qwen3-moe-30b-a3b (9.66e9) are drawn by slices."""
    import math

    def largest(arch):
        return max(math.prod(m.shape) for m in
                   leaves(params.abstract_params(get_config(arch))))

    for arch in ("starcoder2-3b", "qwen2-vl-2b"):
        assert largest(arch) <= params.WHOLE_DRAW_ELEMENTS
    assert largest("qwen3-moe-30b-a3b") > params.WHOLE_DRAW_ELEMENTS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_draw_shape_dtype_and_std(monkeypatch, dtype):
    """With the threshold lowered, every normal leaf of the reduced MoE
    preset larger than it is drawn slice by slice: the tree's shapes and
    dtypes are unchanged, each sliced leaf's std is 0.02, its slices
    differ from one another, and zeros / ones leaves are as before."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    monkeypatch.setattr(params, "WHOLE_DRAW_ELEMENTS", 4096)
    got = params.init_params(cfg, torch.Generator().manual_seed(4),
                             device="cpu", dtype=dtype)
    metas = dict(_flat(params.abstract_params(cfg)))
    sliced = 0
    for k, t in _flat(got):
        m = metas[k]
        assert tuple(t.shape) == m.shape and t.dtype == dtype, k
        if m.init != "normal":
            assert bool((t == (1 if m.init == "ones" else 0)).all()), k
            continue
        if t.numel() > 4096:
            sliced += 1
            assert abs(float(t.float().std()) - 0.02) < 2e-3, k
            assert not torch.equal(t[0], t[1]), k
    assert sliced >= 4           # the expert leaves and the embeddings
