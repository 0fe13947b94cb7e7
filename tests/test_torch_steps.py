"""The port's mesh, rule table, cell constructors and dry run against the JAX
package's ``launch/mesh.py``, ``parallel/sharding.py``, ``launch/steps.py``
and ``launch/dryrun.py``, on the CPU.

The rule table's specs are held leaf by leaf at full size on the JAX dry
run's 16 x 16 and 2 x 16 x 16 meshes: a port segment leaf is one layer's
(the port keeps per-layer lists), so its spec is the JAX spec without its
leading layer entry. The ``build_*`` steps run at reduced size in f32 from
the same params (the port's init, bridged to the JAX package) against
``jax.jit`` of the JAX ``build_*`` functions."""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AbstractMesh, PartitionSpec as P
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ASSIGNED_ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import ShapeConfig as JShapeConfig
from repro.configs import get_config, reduced
from repro.core import mpsl as jmpsl
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.parallel import sharding as jsharding
from repro_torch import bridge, tree
from repro_torch.configs import SHAPES, ShapeConfig, list_archs
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduced as treduced
from repro_torch.core import mpsl, split
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.parallel import sharding

# reduced f32 cells, the same math in both packages through 2 layers: the
# loss and logits to 1e-4; each gradient leaf (AdamW's first moment after
# one step, (1 - b1) x the clipped gradient) to 1e-3 in relative L2
LOSS_TOL = 1e-4
GRAD_TOL = 1e-3
SERVE_TOL = 1e-4

# XLA's CPU backend without its costly LLVM passes: the same f32 math,
# compiled in a third less time
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def _jit(fn):
    return jax.jit(fn, compiler_options=FAST_XLA)


def _abstract_mesh(sizes, names):
    try:
        return AbstractMesh(sizes, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


JMESHES = {"16x16": _abstract_mesh((16, 16), ("data", "model")),
           "2x16x16": _abstract_mesh((2, 16, 16), ("pod", "data", "model"))}
TMESHES = {"16x16": mesh_lib.make_production_mesh(),
           "2x16x16": mesh_lib.make_production_mesh(multi_pod=True)}


def _jspec_map(specs):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {jsharding._path_names(p): tuple(s) for p, s in leaves}


def _spec_items(specs, path=()):
    """(path, spec) of a port spec tree: dicts and lists hold specs, a
    spec is a tuple."""
    if specs is None:
        return []
    if isinstance(specs, dict):
        return [x for k, v in specs.items()
                for x in _spec_items(v, path + (str(k),))]
    if isinstance(specs, list):
        return [x for i, v in enumerate(specs)
                for x in _spec_items(v, path + (str(i),))]
    return [(path, tuple(specs))]


def _tspec_map(specs):
    return dict(_spec_items(specs))


def _hold_specs(tspecs, jspecs):
    """Every port leaf's spec equals the JAX leaf's, a per-layer leaf's
    the JAX one past its layer entry; every JAX leaf is met."""
    jmap, tmap = _jspec_map(jspecs), _tspec_map(tspecs)
    met = set()
    for path, spec in tmap.items():
        if "segments" in path:
            i = path.index("segments")
            jpath = path[:i + 2] + path[i + 3:]
            want = jmap[jpath][1:]
        else:
            jpath = path
            want = jmap[jpath]
        assert spec == want, (path, spec, want)
        met.add(jpath)
    assert met == set(jmap), set(jmap) - met


# ---------------------------------------------------------------------------
# rules


def test_resolve_divisibility_fallbacks():
    mesh = TMESHES["16x16"]
    with sharding.use_mesh(mesh):
        assert sharding.resolve_spec(mesh, (4096, 64, 128),
                                     ("fsdp", "model", None)) \
            == ("data", "model", None)
        assert sharding.resolve_dim(mesh, 24, "model") is None
        assert sharding.resolve_dim(mesh, 1600, ("dboth", "model")) \
            == "model"
        assert sharding.resolve_dim(mesh, 3072, ("dboth", "model")) \
            == ("data", "model")
        assert sharding.resolve_dim(mesh, 8, None) is None
    mesh3 = TMESHES["2x16x16"]
    assert sharding.resolve_dim(mesh3, 64, "client") == ("pod", "data")
    assert sharding.resolve_dim(mesh3, 48, "client") is None
    assert sharding.shard_shape((64, 24, 7), (("pod", "data"), None,
                                              "model"), mesh3) == (2, 24, 1)
    host = mesh_lib.Mesh(("data", "model"), (1, 1))
    assert sharding.resolve_spec(host, (4096, 64), ("fsdp", "model")) \
        == (None, None)


@pytest.mark.parametrize("mesh_name", list(TMESHES))
def test_batch_specs_match_jax(mesh_name):
    batch = {"tokens": np.zeros((32, 2, 24), np.int32),
             "labels": np.zeros((48, 2, 24), np.int32),
             "mask": np.zeros((32,), np.float32)}
    want = jsharding.batch_specs(batch, JMESHES[mesh_name])
    got = sharding.batch_specs(batch, TMESHES[mesh_name])
    assert {k: tuple(v) for k, v in want.items()} == got


def test_meshes():
    for name, m in TMESHES.items():
        assert m.name == name
        assert m.size == math.prod(JMESHES[name].axis_sizes)
        assert m.axis_names == JMESHES[name].axis_names
        assert m.shape == dict(zip(JMESHES[name].axis_names,
                                   JMESHES[name].axis_sizes))
    host = mesh_lib.make_host_mesh()
    assert host.axis_names == ("data", "model") and host.shape["model"] == 1
    assert sharding.shard_act(torch.ones(2), ("batch",)).shape == (2,)


@functools.lru_cache(maxsize=None)
def _jax_abstract_params(arch):
    """The JAX package's full-size params, abstract (both meshes'
    cases read them)."""
    return jax.eval_shape(lambda k: JM.init_lm(k, JARCHS[arch]),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh_name", list(TMESHES))
def test_param_specs_match_jax_at_full_size(mesh_name):
    jm, tm = JMESHES[mesh_name], TMESHES[mesh_name]
    for arch in list_archs():
        jparams = _jax_abstract_params(arch)
        tparams = steps.abstract_serve_params(tget_config(arch), "float32")
        _hold_specs(sharding.param_specs(tparams, tm),
                    jsharding.param_specs(jparams, jm))


@pytest.mark.parametrize("mesh_name", list(TMESHES))
def test_mpsl_train_tree_specs_match_jax(mesh_name):
    jm, tm = JMESHES[mesh_name], TMESHES[mesh_name]
    for arch in ("minitron-4b", "hymba-1.5b", "qwen3-moe-235b-a22b",
                 "whisper-tiny", "qwen2-vl-72b", "falcon-mamba-7b"):
        jcfg, tcfg = JARCHS[arch], tget_config(arch)
        jrun = jsteps.default_run(jcfg, JSHAPES["train_4k"], jm)
        trun = steps.default_run(tcfg, SHAPES["train_4k"], tm)
        jstate = jsteps.abstract_train_state(jcfg, jrun)
        tstate = steps.abstract_train_state(tcfg, trun)
        tspec = steps.state_specs(tstate, tm)
        for part in ("params", "frozen"):
            _hold_specs(tspec[part], jsharding.param_specs(jstate[part], jm))
        _hold_specs(tspec["opt"]["mu"],
                    jsharding.param_specs(jstate["opt"]["mu"], jm))


@pytest.mark.parametrize("mesh_name", list(TMESHES))
def test_cache_specs_match_jax(mesh_name):
    jm, tm = JMESHES[mesh_name], TMESHES[mesh_name]
    for arch in list_archs():
        jcfg, tcfg = JARCHS[arch], tget_config(arch)
        jcache = jax.eval_shape(
            lambda: JM.init_body_cache(jcfg, 128, 32768, jnp.bfloat16))
        tcache = steps.abstract_serve_cache(tcfg, 128, 32768)
        _hold_specs({"segments": sharding.cache_specs(tcache, tm)},
                    {"segments": jsharding.cache_specs(jcache, jm)})
        with jsharding.use_mesh(jm):
            jserve = jax.tree_util.tree_map_with_path(
                lambda p, leaf: jsharding.resolve_spec(
                    jm, leaf.shape, jsharding.cache_dims(
                        tuple(leaf.shape), jsharding._path_names(p)[-1],
                        stacked=True, kv_heads=jcfg.num_kv_heads)), jcache)
        _hold_specs({"segments": steps.serve_cache_specs(tcache, tm, tcfg)},
                    {"segments": jserve})


# ---------------------------------------------------------------------------
# run defaults and abstract inputs


def _run_fields(run):
    d = {f.name: getattr(run, f.name) for f in dataclasses.fields(run)
         if f.name not in ("model", "shape", "mpsl")}
    d["mpsl"] = dataclasses.asdict(run.mpsl)
    return d


def test_default_run_matches_jax_for_every_cell():
    meshes = [(JMESHES[n], TMESHES[n]) for n in TMESHES]
    meshes.append((jax.make_mesh((1, 1), ("data", "model")),
                   mesh_lib.Mesh(("data", "model"), (1, 1))))
    for jm, tm in meshes:
        for arch in list_archs():
            for name in SHAPES:
                jcfg, tcfg = JARCHS[arch], tget_config(arch)
                jrun = jsteps.default_run(jcfg, JSHAPES[name], jm)
                trun = steps.default_run(tcfg, SHAPES[name], tm)
                assert _run_fields(trun) == _run_fields(jrun), (arch, name)
                n = steps.n_data_shards(tm)
                assert n == jsteps.n_data_shards(jm)
                for bn in (1, 2, 16, 256):
                    assert steps.choose_microbatches(
                        tcfg, SHAPES[name], n, bn) == \
                        jsteps.choose_microbatches(jcfg, JSHAPES[name], n, bn)
    over = steps.default_run(tget_config("minitron-4b"), SHAPES["train_4k"],
                             TMESHES["16x16"], n_clients=4, remat="none")
    assert over.mpsl.n_clients == 4 and over.remat == "none"


def _shapes(t):
    return [(tuple(x.shape), str(x.dtype).split(".")[-1])
            for x in jax.tree_util.tree_leaves(t)]


def _hold_abstract(ttree, jtree):
    """The port's meta leaves against the JAX abstract ones, shape and
    dtype: a per-layer leaf (under "segments") against the JAX stacked
    leaf past its layer dim, one per layer. A KV cache's int index has no
    tensor in the port."""
    jmap = {jsharding._path_names(p): a
            for p, a in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    groups = {}

    def visit(path, x):
        if not isinstance(x, torch.Tensor):
            return
        key = path
        if "segments" in path:
            i = path.index("segments")
            key = path[:i + 2] + path[i + 3:]
        groups.setdefault(key, []).append(x)
    sharding._map_with_path(visit, ttree)
    assert {k for k in jmap if k[-1] != "index"} == set(groups)
    for key, xs in groups.items():
        a = jmap[key]
        want = tuple(a.shape)
        if "segments" in key:
            assert a.shape[0] == len(xs), key
            want = want[1:]
        for x in xs:
            assert tuple(x.shape) == want, (key, x.shape, a.shape)
            assert str(x.dtype).split(".")[-1] == str(a.dtype), key


@pytest.mark.parametrize("arch", ["minitron-4b", "hymba-1.5b",
                                  "qwen2-moe-a2.7b", "whisper-tiny",
                                  "qwen2-vl-72b", "falcon-mamba-7b"])
def test_abstract_inputs_match_jax(arch):
    jm = jax.make_mesh((1, 1), ("data", "model"))
    tm = mesh_lib.Mesh(("data", "model"), (1, 1))
    jcfg, tcfg = JARCHS[arch], tget_config(arch)
    jrun = jsteps.default_run(jcfg, JSHAPES["train_4k"], jm)
    trun = steps.default_run(tcfg, SHAPES["train_4k"], tm)
    assert _shapes(steps.train_batch_specs(tcfg, trun)) == \
        _shapes(jsteps.train_batch_specs(jcfg, jrun))
    js, ts = jsteps.abstract_train_state(jcfg, jrun), \
        steps.abstract_train_state(tcfg, trun)
    for part in ("params", "frozen"):
        _hold_abstract({part: ts[part]}, {part: js[part]})
    _hold_abstract({"mu": ts["opt"]["mu"]}, {"mu": js["opt"]["mu"]})
    assert ts["opt"]["count"].dtype == torch.int32
    _hold_abstract({"segments": steps.abstract_serve_cache(tcfg, 4, 4096)},
                   {"segments": jsteps.abstract_serve_cache(jcfg, 4, 4096)})
    jckv, tckv = jsteps.abstract_cross_kv(jcfg, 4), \
        steps.abstract_cross_kv(tcfg, 4)
    assert (jckv is None) == (tckv is None)
    if tckv is not None:
        _hold_abstract({"segments": tckv}, {"segments": jckv})


# ---------------------------------------------------------------------------
# the build_* steps against the JAX package (reduced, f32)

BUILD_ARCHS = ["minitron-4b", "hymba-1.5b", "qwen2-moe-a2.7b",
               "whisper-tiny", "qwen2-vl-72b"]


def _cell(arch, kind, seq, batch, **over):
    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]
    jcfg, tcfg = reduced(get_config(arch)), treduced(tget_config(arch))
    jm = jax.make_mesh((1, 1), ("data", "model"))
    tm = mesh_lib.Mesh(("data", "model"), (1, 1))
    # a short scan chunk: the scan pads the sequence to whole chunks
    kw = dict(compute_dtype="float32", ssm_chunk=4, **over)
    jrun = jsteps.default_run(jcfg, JShapeConfig(name, seq, batch, kind), jm,
                              **kw)
    trun = steps.default_run(tcfg, ShapeConfig(name, seq, batch, kind), tm,
                             **kw)
    return jcfg, tcfg, jrun, trun, jm, tm


def _seq(cfg, text):
    return text + (steps.VLM_PATCH_TOKENS if cfg.family == "vlm" else 0)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch", BUILD_ARCHS)
def test_build_train_matches_jax(arch):
    jcfg, tcfg, jrun, trun, jm, tm = _cell(
        arch, "train", _seq(reduced(get_config(arch)), 12), 4, n_clients=2,
        trainable_blocks=1, microbatches=2)
    assert trun.microbatches == 2 and trun.mpsl.n_clients == 2
    # the port's init (the JAX one is eager and slow), bridged to both
    tparams, tfrozen, _ = split.init_mpsl_lm(torch.Generator().manual_seed(0),
                                             tcfg, trun)
    params, frozen = bridge.to_repro(tparams), bridge.to_repro(tfrozen)
    rng = np.random.default_rng(0)
    b = params["client"]["adapter"]["b"]
    params["client"]["adapter"]["b"] = \
        0.05 * rng.standard_normal(b.shape).astype(np.float32)
    a_batch = steps.train_batch_specs(tcfg, trun)
    nb = {}
    for k, v in a_batch.items():
        if k in ("tokens", "labels"):
            nb[k] = rng.integers(0, tcfg.vocab_size, v.shape).astype(np.int32)
        elif k == "mask":
            nb[k] = np.ones(v.shape, np.float32)
        else:
            nb[k] = 0.02 * rng.standard_normal(v.shape).astype(np.float32)

    jfn, _, _, _ = jsteps.build_train(jcfg, jrun, jm)
    jstate, jmet = _jit(jfn)(jmpsl.init_state(params, frozen),
                                {k: jnp.asarray(v) for k, v in nb.items()})
    tfn, _, _, _ = steps.build_train(tcfg, trun, tm)
    state = mpsl.init_state(bridge.from_repro(params),
                            bridge.from_repro(frozen))
    state, met = tfn(state, {k: torch.from_numpy(v) for k, v in nb.items()})
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
        LOSS_TOL * abs(float(jmet["loss"]))
    got = tree.leaves(bridge.to_repro(state["opt"]["mu"]))
    want = jax.tree_util.tree_leaves(_np(jstate["opt"]["mu"]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel_l2(g, w) <= GRAD_TOL


def _vlm_positions_fixed(monkeypatch):
    """The JAX ``build_prefill`` hands ``_build_positions`` [B, P, D]
    patches, read on axis 2 (ROADMAP.md Queue 3): hand it the patches
    on axis 2 instead."""
    orig = jmpsl._build_positions
    monkeypatch.setattr(jmpsl, "_build_positions", lambda cfg, batch, b, s:
                        orig(cfg, {"patch_embeds": batch["patch_embeds"][
                            :, None]}, b, s))


@pytest.mark.parametrize("arch", BUILD_ARCHS)
def test_build_prefill_matches_jax(arch, monkeypatch):
    _vlm_positions_fixed(monkeypatch)
    jcfg, tcfg, jrun, trun, jm, tm = _cell(
        arch, "prefill", _seq(reduced(get_config(arch)), 20), 2)
    params = bridge.to_repro(M.init_lm(tcfg,
                                       torch.Generator().manual_seed(0)))
    jfn, (_, a_batch), _ = jsteps.build_prefill(jcfg, jrun, jm)
    rng = np.random.default_rng(1)
    nb = {k: (rng.integers(0, jcfg.vocab_size, v.shape).astype(np.int32)
              if k == "tokens" else
              0.02 * rng.standard_normal(v.shape).astype(np.float32))
          for k, v in a_batch.items()}
    jlog, jcache = _jit(jfn)(params, {k: jnp.asarray(v)
                                         for k, v in nb.items()})
    tfn, (_, t_batch), _ = steps.build_prefill(tcfg, trun, tm)
    assert {k: tuple(v.shape) for k, v in t_batch.items()} == \
        {k: v.shape for k, v in nb.items()}
    tlog, tcache = tfn(bridge.from_repro(params),
                       {k: torch.from_numpy(v) for k, v in nb.items()})
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=SERVE_TOL, rtol=SERVE_TOL)
    for g, w in zip(jax.tree_util.tree_leaves(bridge.cache_to_repro(tcache)),
                    jax.tree_util.tree_leaves(_np(jcache))):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64),
                                   atol=SERVE_TOL, rtol=SERVE_TOL)


def _seeded_cache(tcfg, b, cache_len, filled, rng):
    """A port cache of `cache_len` slots whose first `filled` hold seeded
    K/V (positions 0..filled-1), SSM state and conv history."""
    cache = M.init_body_cache(tcfg, b, cache_len, torch.float32)

    def fill(d):
        for k, v in d.items():
            if isinstance(v, dict):
                fill(v)
            elif k in ("k", "v", "h", "conv"):
                v.copy_(torch.from_numpy(
                    rng.standard_normal(tuple(v.shape)).astype(np.float32)))
        if "pos" in d:
            n = min(filled, d["pos"].shape[1])
            d["pos"][:] = -1
            d["pos"][:, :n] = torch.arange(filled - n, filled,
                                           dtype=torch.int32)
            d["index"] = filled
    for seg in cache:
        for layer in seg:
            fill(layer)
    return cache


@pytest.mark.parametrize("arch", BUILD_ARCHS)
def test_build_decode_matches_jax(arch):
    cache_len, filled, b = 32, 20, 2
    jcfg, tcfg, jrun, trun, jm, tm = _cell(arch, "decode", cache_len, b)
    params = bridge.to_repro(M.init_lm(tcfg,
                                       torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(2)
    tcache = _seeded_cache(tcfg, b, cache_len, filled, rng)
    jcache = jax.tree_util.tree_map(jnp.asarray,
                                    bridge.cache_to_repro(tcache))
    tckv = jckv = None
    if tcfg.encoder_layers:
        enc = tcfg.encoder_seq
        tckv = [[{"k": torch.from_numpy(rng.standard_normal(
                      (b, enc, tcfg.num_kv_heads, tcfg.resolved_head_dim))
                      .astype(np.float32)),
                  "v": torch.from_numpy(rng.standard_normal(
                      (b, enc, tcfg.num_kv_heads, tcfg.resolved_head_dim))
                      .astype(np.float32)),
                  "pos": torch.arange(enc, dtype=torch.int32)[None]
                  .expand(b, enc).contiguous()}
                 for _ in range(seg.count)] if seg.kind.cross else None
                for seg in M.body_segments(tcfg)]
        jckv = [None if s is None else {
            k: jnp.stack([jnp.asarray(layer[k].numpy()) for layer in s])
            for k in ("k", "v", "pos")} for s in tckv]
    tokens = rng.integers(0, tcfg.vocab_size, (b, 1)).astype(np.int32)
    pos = np.full((b, 3, 1) if tcfg.pos_embed == "mrope" else (b, 1),
                  filled, np.int32)
    jfn, _, _, _ = jsteps.build_decode(jcfg, jrun, jm)
    jlog, jnew = _jit(jfn)(params, jcache, jckv, jnp.asarray(tokens),
                              jnp.asarray(pos))
    tfn, _, _, _ = steps.build_decode(tcfg, trun, tm)
    tlog, tnew = tfn(bridge.from_repro(params), tcache, tckv,
                     torch.from_numpy(tokens), torch.from_numpy(pos))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=SERVE_TOL, rtol=SERVE_TOL)
    for g, w in zip(jax.tree_util.tree_leaves(bridge.cache_to_repro(tnew)),
                    jax.tree_util.tree_leaves(_np(jnew))):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64),
                                   atol=SERVE_TOL, rtol=SERVE_TOL)


# ---------------------------------------------------------------------------
# the dry run


JAX_RECORD_KEYS = {"arch", "shape", "mesh", "status", "kind", "microbatches",
                   "n_clients", "flops_per_device", "bytes_per_device",
                   "collective_bytes_per_device", "memory", "lower_s",
                   "compile_s"}


def _tensor_leaves(t):
    """Leaves of a data tree in ``_spec_items``' order (dict insertion
    order, not sorted)."""
    if t is None:
        return []
    if isinstance(t, dict):
        return [x for v in t.values() for x in _tensor_leaves(v)]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _tensor_leaves(v)]
    return [t]


def _real_args(tree_, gen):
    def real(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.dtype in (torch.int32, torch.int64):
            return torch.randint(0, 8, x.shape, dtype=x.dtype, generator=gen)
        return 0.02 * torch.randn(x.shape, generator=gen).to(x.dtype)
    return tree.map_(real, tree_)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_run_cell_counts_bytes_and_flops(kind):
    cfg = treduced(tget_config("minitron-4b"))
    seq = {"train": 16, "prefill": 24, "decode": 32}[kind]
    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]
    shape = ShapeConfig(name, seq, 4, kind)
    over = dict(compute_dtype="float32")
    if kind == "train":
        over.update(n_clients=2, microbatches=2, trainable_blocks=1)
    rec = dryrun.run_cell("minitron-4b", name, host_mesh=True, cfg=cfg,
                          shape=shape, overrides=over, verbose=False)
    assert JAX_RECORD_KEYS <= set(rec) and rec["status"] == "ok"
    assert rec["collective_bytes_per_device"] == {}
    tm = dryrun.mesh_for(host_mesh=True)
    run = dataclasses.replace(steps.default_run(cfg, shape, tm, **over),
                              ssm_impl="assoc")
    gen = torch.Generator().manual_seed(0)
    fc = FlopCounterMode(display=False)
    if kind == "train":
        fn, a_state, a_batch, (s_sp, b_sp) = steps.build_train(cfg, run, tm)
        want_args = sum(
            math.prod(sharding.shard_shape(x.shape, s, tm)) * x.element_size()
            for t, sp in ((a_state["params"], s_sp["params"]),
                          (a_state["frozen"], s_sp["frozen"]),
                          (a_state["opt"]["mu"], s_sp["opt"]["mu"]),
                          (a_state["opt"]["nu"], s_sp["opt"]["nu"]),
                          (a_batch, b_sp))
            for x, (_, s) in zip(_tensor_leaves(t), _spec_items(sp)))
        want_args += 4                                   # AdamW's count
        params, frozen, _ = split.init_mpsl_lm(gen, cfg, run)
        state = mpsl.init_state(params, frozen)
        batch = _real_args(a_batch, gen)
        batch["mask"] = torch.ones_like(batch["mask"])
        with fc:
            fn(state, batch)
    else:
        build = steps.build_prefill if kind == "prefill" else \
            steps.build_decode
        fn, args, specs = build(cfg, run, tm)[:3]
        want_args = sum(
            math.prod(sharding.shard_shape(x.shape, s, tm)) * x.element_size()
            for a, sp in zip(args, specs)
            for x, (_, s) in zip(_tensor_leaves(a), _spec_items(sp))
            if isinstance(x, torch.Tensor))
        args = _real_args(args, gen)
        with fc:
            fn(*args)
    assert rec["memory"]["argument_size_in_bytes"] == want_args
    assert rec["flops_per_device"] == fc.get_total_flops()
    assert rec["memory"]["temp_size_in_bytes"] > 0
