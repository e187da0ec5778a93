"""The port's sharding (`repro_torch.dist.sharding`, `param_pspecs`,
`param_shapes`, `cache_pspecs`, the sharded decode and the trainer's
``--dp-mode pjit`` / ``--mesh DxM``) against the JAX package's.

* Metadata, in process: the sharding half of tests/test_sharding_rules.py
  on the port; `ShardingRules.spec` for every logical-axis tuple of
  `abstract_params` and `cache_axes` of the ten presets at full size,
  under each scheme on the meshes {data 16, model 16}, {pod 2, data 16,
  model 16} and {graph 8}; `param_pspecs`, `param_shapes` and
  `cache_pspecs` leaf by leaf: all equal to the JAX package's.
* Layouts and decode, in one spawn of 4 gloo ranks on a 2x2 mesh:
  distributing a tensor and gathering it back is the identity, and each
  rank's shard has the shape of the JAX `NamedSharding.shard_shape`
  (computed in a `tests/_subproc.py` payload with 4 forced host
  devices; an uneven dim takes DTensor's ceil-sized chunks, which JAX's
  jit refuses); the reduced starcoder2-3b prefill and 4 serve steps
  with the cache laid out by `cache_pspecs` equal the unsharded ones
  (next tokens equal, logits and cache within 1e-5).
* The launcher on 2x2 (4 gloo ranks each): ``--dp-mode pjit`` losses
  within 1e-5 of the plain launcher's; a crash at step 2 and
  ``--resume`` give the uninterrupted run's losses; its checkpoint
  restores with no mesh and in the JAX `restore_arrays`; ``--dp-mode
  gossip --mesh 2x2`` within 1e-5 of the plain launcher (exact
  consensus on the 2-rank data ring).

The JAX package is imported only inside the tests and fixtures: the
ranks import this module to find their entry point.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist import sharding
from repro_torch.examples import spawn
from repro_torch.models import decode as tdecode
from repro_torch.models import params as tparams
from repro_torch.tree import leaves, leaves_with_paths

SCHEMES = ["default", "tp", "fsdp", "fsdp_noep"]
MESHES = {"data16-model16": {"data": 16, "model": 16},
          "pod2-data16-model16": {"pod": 2, "data": 16, "model": 16},
          "graph8": {"graph": 8}}
TOL = 1e-5


class FakeMesh:
    """Duck-typed mesh: rules only need axis_names/axis_sizes."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.axis_sizes = tuple(sizes.values())


def _jax_flat(tree):
    import jax

    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=_is_jax_leaf)[0]:
        out[tuple(k.key for k in path)] = v
    return out


def _is_jax_leaf(x):
    from jax.sharding import PartitionSpec

    from repro.models.params import ParamMeta

    return isinstance(x, (ParamMeta, PartitionSpec))


# ---------------------------------------------------------------------------
# metadata
# ---------------------------------------------------------------------------
def _unit_case(name, mod):
    """One of tests/test_sharding_rules.py's cases on `mod` (either
    package's dist.sharding): the specs it computes, as tuples."""
    mesh = FakeMesh({"data": 16, "model": 16})
    if name == "default_scheme_tp_axes":
        r = mod.ShardingRules(mapping={"batch": ("pod", "data"),
                                       "heads": "model", "embed": None},
                              mesh=mesh)
        return [r.spec("batch", "seq", "embed"), r.spec(None, "heads")]
    if name == "spec_deduplicates_mesh_axes":
        r = mod.ShardingRules(mapping={"batch": ("data", "model"),
                                       "embed": ("data", "model")},
                              mesh=mesh)
        return [r.spec("batch", "embed")]
    if name == "fsdp_scheme_weights_vs_activations":
        mapping = dict(mod._BASE)
        mapping.update(mod._SCHEMES["fsdp"])
        r = mod.ShardingRules(mapping=mapping, mesh=mesh)
        return [r.spec("layers", "embed", "heads"),
                r.spec("batch", "seq", "embed"),
                r.spec("moe_group", "expert", None, None)]
    r = mod.ShardingRules.null()
    return [r.spec("batch")]


UNIT = {"default_scheme_tp_axes": [("data", None, None), (None, "model")],
        "spec_deduplicates_mesh_axes": [(("data", "model"), None)],
        "fsdp_scheme_weights_vs_activations": [
            (None, ("data", "model"), None),
            (("data", "model"), None, None),
            ("data", "model", None, None)],
        "null_rules": [(None,)]}


@pytest.mark.parametrize("name", sorted(UNIT))
def test_sharding_rules_unit_cases_match_jax(name):
    from repro.dist import sharding as jsharding

    got = [tuple(s) for s in _unit_case(name, sharding)]
    want = [tuple(s) for s in _unit_case(name, jsharding)]
    assert got == want == UNIT[name]
    assert all(isinstance(s, sharding.PartitionSpec)
               for s in _unit_case(name, sharding))


def test_tables_and_null_rules_match_jax():
    from repro.dist import sharding as jsharding

    assert sharding._BASE == jsharding._BASE
    assert sharding._SCHEMES == jsharding._SCHEMES
    rules = sharding.ShardingRules.null()
    x = torch.ones(4, 4)
    assert rules.constrain(x, "batch", "embed") is x
    assert rules.distribute(x, "batch", "embed") is x
    mesh = FakeMesh({"data": 2})
    with pytest.raises(KeyError) as got:
        sharding.make_rules(mesh, "nope")
    with pytest.raises(KeyError) as want:
        jsharding.make_rules(mesh, "nope")
    assert str(got.value) == str(want.value)
    assert sharding.make_rules(mesh, "fsdp") is sharding.make_rules(mesh,
                                                                    "fsdp")


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh({"data": 2, "model": 2})
    R, S = Replicate(), Shard
    P = sharding.PartitionSpec
    cases = [(P("data", None), (S(0), R)), (P(None, "model"), (R, S(1))),
             (P("data", "model"), (S(0), S(1))),
             (P("model", "data"), (S(1), S(0))),
             (P(("data", "model"), None), (S(0), S(0))), (P(), (R, R))]
    for spec, want in cases:
        assert sharding.placements(spec, mesh) == want, spec
    with pytest.raises(ValueError, match="order"):
        sharding.placements(P(("model", "data")), mesh)


def _axes_tuples(jcfg):
    from repro.models.decode import cache_axes
    from repro.models.params import abstract_params

    metas = _jax_flat(abstract_params(jcfg))
    return sorted({m.axes for m in metas.values()}
                  | {a for a in cache_axes(jcfg).values()}, key=str)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_spec_of_every_logical_axes_tuple_matches_jax(scheme, mesh):
    from repro.configs import get_config as jget_config
    from repro.dist.sharding import make_rules as jmake_rules

    fake = FakeMesh(MESHES[mesh])
    ours, ref = sharding.make_rules(fake, scheme), jmake_rules(fake, scheme)
    n = 0
    for arch in ARCH_IDS:
        for axes in _axes_tuples(jget_config(arch)):
            assert tuple(ours.spec(*axes)) == tuple(ref.spec(*axes)), (
                arch, axes)
            n += 1
    assert n > 100


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_and_shapes_match_jax(arch):
    """param_pspecs, param_shapes (shape and dtype), param_shardings and
    cache_pspecs leaf by leaf, full size, every scheme on 16 x 16."""
    from repro.configs import get_config as jget_config
    from repro.dist.sharding import make_rules as jmake_rules
    from repro.models import decode as jdecode
    from repro.models import params as jparams

    jcfg, cfg = jget_config(arch), get_config(arch)
    fake = FakeMesh({"data": 16, "model": 16})
    shapes = dict(leaves_with_paths(tparams.param_shapes(cfg)))
    jshapes = _jax_flat(jparams.param_shapes(jcfg))
    assert sorted(shapes) == sorted(jshapes)
    for k, t in shapes.items():
        assert t.device.type == "meta" and tuple(t.shape) == \
            jshapes[k].shape, k
        assert str(t.dtype) == f"torch.{jshapes[k].dtype}", k
    bf = tparams.param_shapes(cfg, torch.bfloat16)
    assert {t.dtype for t in leaves(bf)} == {torch.bfloat16}
    for scheme in SCHEMES:
        rules, jrules = sharding.make_rules(fake, scheme), jmake_rules(
            fake, scheme)
        specs = dict(tparams.spec_leaves(tparams.param_pspecs(cfg, rules)))
        jspecs = _jax_flat(jparams.param_pspecs(jcfg, jrules))
        assert sorted(specs) == sorted(jspecs)
        for k, s in specs.items():
            assert isinstance(s, sharding.PartitionSpec)
            assert tuple(s) == tuple(jspecs[k]), (scheme, k)
        shard = tparams.param_shardings(cfg, rules)
        for k, s in specs.items():
            node = shard
            for part in k:
                node = node[part]
            assert node == (fake, s, sharding.placements(s, fake)), k
        cache = tdecode.cache_pspecs(cfg, rules)
        jcache = jdecode.cache_pspecs(jcfg, jrules)
        assert sorted(cache) == sorted(jcache)
        for k, s in cache.items():
            assert tuple(s) == tuple(jcache[k]), (scheme, k)


# ---------------------------------------------------------------------------
# layouts and decode on 4 gloo ranks
# ---------------------------------------------------------------------------
#: (shape, spec) on the ("data", "model") 2x2 mesh; the last two are
#: uneven.
LAYOUTS = [((8, 6), ("data", None)), ((8, 6), (None, "model")),
           ((8, 6), ("data", "model")), ((8, 4), (("data", "model"), None)),
           ((4, 8, 6), (None, ("data", "model"), None)), ((2, 6), ()),
           ((6, 5), ("data", "model")), ((3, 7), (("data", "model"), None))]
EVEN = 6

_SHARD_SHAPES = r"""
import json
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_test_mesh

mesh = make_test_mesh((2, 2))
out = []
for shape, spec in json.loads(LAYOUTS):
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    out.append(list(NamedSharding(mesh, P(*spec)).shard_shape(tuple(shape))))
print(json.dumps(out))
"""


def _decode_case(rules):
    """The reduced starcoder2-3b prefill (6 tokens) and 4 serve steps,
    sharded by `rules` and unsharded from the same weights: the largest
    logit and cache differences and whether the next tokens agreed."""
    from repro_torch.models.model import RunConfig
    from repro_torch.models.steps import build_serve_step

    cfg = get_config("starcoder2-3b").reduced()
    run = RunConfig("ref")
    p = tparams.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    ps = tparams.distribute_params(p, tparams.param_pspecs(cfg, rules),
                                   rules.mesh)
    B, S, n = 4, 6, 4
    prompt = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    c0 = tdecode.start_cache(cfg, p, B, S + n, run)
    c1 = tdecode.start_cache(cfg, ps, B, S + n, run, rules=rules)
    layout = all(tuple(c1[k].placements) == sharding.placements(s, rules.mesh)
                 for k, s in tdecode.cache_pspecs(cfg, rules).items())
    l0, c0 = tdecode.prefill(cfg, p, prompt, c0, run)
    l1, c1 = tdecode.prefill(cfg, ps, rules.distribute(prompt, "batch", None),
                             c1, run, rules=rules)
    logit_err = float((l0 - sharding.full(l1)).abs().max())
    s0, s1 = build_serve_step(cfg, run), build_serve_step(cfg, run,
                                                          rules=rules)
    t0 = l0.argmax(-1)[:, None].to(prompt.dtype)
    t1 = rules.distribute(t0.clone(), "batch", None)
    same = True
    for _ in range(n):
        n0, c0 = s0(p, c0, t0)
        n1, c1 = s1(ps, c1, t1)
        same = same and torch.equal(n0, sharding.full(n1))
        t0, t1 = n0[:, None], n1[:, None]
    cache_err = max(float((c0[k].float() - sharding.full(c1[k]).float())
                          .abs().max()) for k in c0)
    return {"logit_err": logit_err, "cache_err": cache_err, "same": same,
            "idx": int(sharding.full(c1["idx"])), "layout": layout}


def _rank_checks(shard_shapes):
    """This rank's layout checks, then the decode cases; every rank's
    record, gathered."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh((2, 2))
    rec = {"rank": dist.get_rank(), "layouts": []}
    for i, (shape, spec) in enumerate(LAYOUTS):
        spec = sharding.PartitionSpec(
            *[tuple(e) if isinstance(e, list) else e for e in spec])
        full = torch.arange(float(np.prod(shape))).reshape(shape)
        dt = sharding.distribute(full, mesh, spec)
        local = tuple(dt.to_local().shape)
        want = (tuple(shard_shapes[i]) if i < EVEN else tuple(
            sharding.shard_range(n, dt.placements, mesh, d)[1]
            for d, n in enumerate(shape)))
        rec["layouts"].append({"local": local, "want": want,
                               "back": torch.equal(dt.full_tensor(), full)})
    rec["decode"] = {s: _decode_case(sharding.make_rules(mesh, s))
                     for s in ("default", "fsdp")}
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, rec)
    return out


@pytest.fixture(scope="module")
def ranks():
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    from _subproc import run_payload

    code = f"LAYOUTS = {json.dumps(LAYOUTS[:EVEN])!r}\n" + _SHARD_SHAPES
    shapes = json.loads(run_payload(code, n_devices=4).strip().splitlines()[-1])
    return spawn(_rank_checks, 4, shapes)


@pytest.mark.parametrize("i", range(len(LAYOUTS)),
                         ids=[f"{s}-{p}" for s, p in LAYOUTS])
def test_layout_shards_and_round_trips(ranks, i):
    for rec in ranks:
        lay = rec["layouts"][i]
        assert lay["back"], rec["rank"]
        assert lay["local"] == lay["want"], (rec["rank"], lay)


@pytest.mark.parametrize("scheme", ["default", "fsdp"])
def test_sharded_decode_matches_the_unsharded_decode(ranks, scheme):
    for rec in ranks:
        d = rec["decode"][scheme]
        assert d["layout"] and d["same"] and d["idx"] == 10, d
        assert d["logit_err"] <= TOL and d["cache_err"] <= TOL, d


# ---------------------------------------------------------------------------
# the launcher on 2x2
# ---------------------------------------------------------------------------
BASE = ["--arch", "starcoder2-3b", "--smoke", "--steps", "4", "--batch",
        "8", "--seq", "32", "--device", "cpu", "--log-every", "1",
        "--ckpt-every", "2"]


@pytest.fixture(scope="module")
def launcher(tmp_path_factory):
    """The plain launcher, --dp-mode pjit --mesh 2x2 uninterrupted, the
    same crashed at step 2 and resumed, and gossip on 2x2."""
    from repro_torch.launch import train

    tmp = tmp_path_factory.mktemp("launcher")

    def go(*extra):
        return train.train(train.parse_args(BASE + list(extra)))

    out = {"plain": go("--ckpt-dir", str(tmp / "plain")),
           "pjit": go("--dp-mode", "pjit", "--mesh", "2x2", "--ckpt-dir",
                      str(tmp / "pjit"))}
    with pytest.raises(SystemExit) as crash:
        go("--dp-mode", "pjit", "--mesh", "2x2", "--ckpt-dir",
           str(tmp / "ft"), "--fail-at-step", "2")
    out["crash_code"] = crash.value.code
    out["resumed"] = go("--dp-mode", "pjit", "--mesh", "2x2", "--ckpt-dir",
                        str(tmp / "ft"), "--resume")
    out["gossip"] = go("--dp-mode", "gossip", "--mesh", "2x2")
    out["dir"] = tmp
    return out


def test_pjit_on_the_mesh_matches_the_plain_launcher(launcher):
    want, got = launcher["plain"]["losses"], launcher["pjit"]["losses"]
    assert sorted(got) == [0, 1, 2, 3]
    for s in want:
        assert abs(got[s] - want[s]) <= TOL, (s, got[s], want[s])


def test_crash_and_resume_on_the_mesh(launcher):
    assert launcher["crash_code"] == 42
    got, want = launcher["resumed"]["losses"], launcher["pjit"]["losses"]
    assert sorted(got) == [2, 3]
    for s in got:
        assert got[s] == want[s], (s, got[s], want[s])


def test_gossip_on_the_mesh_matches_the_plain_launcher(launcher):
    want, got = launcher["plain"]["losses"], launcher["gossip"]["losses"]
    assert sorted(got) == [0, 1, 2, 3]
    for s in want:
        assert abs(got[s] - want[s]) <= TOL, (s, got[s], want[s])


def test_mesh_checkpoint_restores_anywhere(launcher):
    """The 2x2 run's checkpoint (gathered, written by rank 0) restores
    with no mesh, bit for bit, and in the JAX package's restore."""
    import jax

    from repro.ckpt import load_checkpoint as jload
    from repro.ckpt import restore_arrays as jrestore
    from repro.configs import get_config as jget_config
    from repro.models import init_params as jinit_params
    from repro.optim import adamw_init as jadamw_init
    from repro_torch.ckpt import (latest_checkpoint, load_checkpoint,
                                  restore_arrays)
    from repro_torch.optim import adamw_init

    path = latest_checkpoint(str(launcher["dir"] / "pjit"))
    assert path.endswith("step_00000004")
    step, trees, _ = load_checkpoint(path)
    cfg = get_config("starcoder2-3b").reduced()
    target = tparams.init_params(cfg, torch.Generator().manual_seed(5),
                                 device="cpu")
    params = restore_arrays(trees["params"], target)
    state = restore_arrays(trees["opt_state"], adamw_init(target))
    assert step == 4 and int(state.step) == 4
    for path_, t in leaves_with_paths(params):
        assert torch.equal(t, trees["params"]["/".join(path_)])
    jcfg = jget_config("starcoder2-3b").reduced()
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    jstep, jtrees, _ = jload(path)
    back = jrestore(jtrees["params"], jp)
    jstate = jrestore(jtrees["opt_state"], jadamw_init(jp))
    assert jstep == 4 and int(jstate.step) == 4
    flat = {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(back)[0]}
    for path_, t in leaves_with_paths(params):
        np.testing.assert_array_equal(flat["/".join(path_)], t.numpy())
