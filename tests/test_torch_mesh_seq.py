"""Sequence-sharded activations (``seq_model``) in the SPMD program on the
CPU (gloo), against the same program without them and against the JAX
package.

``RunConfig.seq_shard_acts`` (what ``steps.default_run`` sets for training
at d_model >= 8192) asks for ``act_dims = ("batch", "seq_model", None)``:
between the blocks each model rank keeps only its S/m slice of the
residual stream, and each block gathers it whole. The reduced configs'
d_model is 64, so the flag is set by hand. One world of 4 ranks on the
mesh (2, 2), started once for the module, runs the MPSL loss and its
gradients of each case with and without the flag (4 clients x 2 x 12
tokens, client 1 masked, both links int8 on the JAX draws, the last
block trainable):

  * reduced qwen2-vl-72b (4 patches before 12 tokens, M-RoPE) and reduced
    qwen1.5-110b, 4 heads on 1 KV head: the ``mixed`` attention layout,
    the production layout of the three widest archs on 16 x 16;
  * reduced hymba-1.5b (a global and a sliding-window segment, the scan
    and attention in parallel) and reduced whisper-tiny (its encoder's 16
    frames cut too): the boundary form covers every block family;
  * qwen1.5-110b at 13 tokens, which do not divide the model axis: the
    stream stays whole, as the rule table leaves it.

Held: the loss and every gradient bitwise equal to the run without the
flag (an all-gather only copies); both against the JAX ``make_lm_loss``
at ``test_torch_mesh_step.py``'s limits; the bytes autograd saves over the
forward falling by exactly (m - 1) / m of each block's input (the
checkpoint keeps the S/m slice), and the all-gathers over `model` that
the cut adds, exactly as derived. ``steps.default_run`` sets the flag for
the three full configs' ``train_4k`` (as the JAX package's does) and not
for their prefill or decode.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import _mesh_workers as W
from repro.configs import MPSLConfig, RunConfig, SHAPES, get_config, reduced
from repro.core import mpsl as jmpsl
from repro.launch import steps as jsteps
from repro_torch.configs import SHAPES as TSHAPES
from repro_torch.configs import get_config as tget_config
from repro_torch.core import split
from repro_torch.launch import spmd, steps
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import model as TM

QWEN_VL = {"arch": "qwen2-vl-72b"}
QWEN = {"arch": "qwen1.5-110b"}
HYMBA = {"arch": "hymba-1.5b"}
WHISPER = {"arch": "whisper-tiny", "d_model": 48, "num_heads": 6,
           "num_kv_heads": 6, "head_dim": 8, "vocab_size": 257}
MESH = Mesh(("data", "model"), (2, 2))
N, BN, P = 4, 2, 4
MASK = [1.0, 0.0, 1.0, 1.0]
# (name, config, text tokens): 12 (+ 4 patches) divide the model axis of
# 2, 13 do not
CASES = [("qwen2-vl-72b", QWEN_VL, 12), ("qwen1.5-110b", QWEN, 12),
         ("hymba-1.5b", HYMBA, 12), ("whisper-tiny", WHISPER, 12),
         ("qwen1.5-110b-s13", QWEN, 13)]
JAX_CASES = (0, 1)
# tests/test_torch_mesh_step.py's limits
LOSS_TOL, GRAD_L2_TOL = 1e-4, 1e-3
WIDE = ("qwen2-vl-72b", "qwen1.5-110b", "command-r-plus-104b")


def _mpsl_trees(kw):
    cfg = W._config(kw)
    run = W._port_run(cfg, N, True)
    gen = torch.Generator().manual_seed(0)
    params, frozen, _ = split.init_mpsl_lm(gen, cfg, run)
    params["client"]["adapter"]["b"].normal_(0.0, 0.05, generator=gen)
    return W.bridge.to_repro(params), W.bridge.to_repro(frozen)


def _batch(cfg, s, seed=4):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (N, BN, s)),
           "labels": rng.integers(0, cfg.vocab_size, (N, BN, s)),
           "mask": np.asarray(MASK, np.float32)}
    if cfg.family in ("vlm", "audio"):
        key, n = (("patch_embeds", P) if cfg.family == "vlm"
                  else ("frame_embeds", cfg.encoder_seq))
        out[key] = (0.02 * rng.standard_normal(
            (N, BN, n, cfg.d_model))).astype(np.float32)
    return out


def _seq(cfg, s):
    return s + (P if cfg.family == "vlm" else 0)


def _draws(cfg, s):
    """The uniforms the JAX step draws at step 0 of a state seeded 9."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(9), 0),
                             1)
    r_up, r_down = jax.random.split(key)
    shape = (N, BN, _seq(cfg, s), cfg.d_model)
    return {"uplink": np.array(jax.random.uniform(r_up, shape)),
            "downlink": np.array(jax.random.uniform(r_down, shape))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    args = []
    for _, kw, s in CASES:
        cfg = W._config(kw)
        params, frozen = _mpsl_trees(kw)
        args.append((kw, params, frozen, _batch(cfg, s), _draws(cfg, s)))
    res = spmd.spawn(W.seq_cases, MESH, "cpu", 300,
                     args=([MESH], args, [_prefill_args()]),
                     workdir=tmp_path_factory.mktemp("seq"))
    return args, [r[MESH.name][0] for r in res], \
        [r[MESH.name][1] for r in res]


def _prefill_args():
    """Reduced qwen1.5-110b served: its 1 KV head divides no model axis of
    2, so the caches lie on the sequence; 4 prompts of 12 tokens."""
    params = W.bridge.to_repro(TM.init_lm(W._config(QWEN),
                                          torch.Generator().manual_seed(5)))
    tokens = np.random.default_rng(5).integers(0, 256, (4, 12))
    return QWEN, params, tokens


def _rel_l2(got, want):
    den = float(np.linalg.norm(want)) or 1.0
    return float(np.linalg.norm(np.asarray(got) - want)) / den


def _divides(cfg, s):
    return _seq(cfg, s) % MESH.shape["model"] == 0


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_bitwise_the_whole_streams(world, i):
    """The loss, every client's loss and every gradient with the flag are
    the bits of the run without it, on every rank."""
    for rank in world[1]:
        whole, seq = rank[i]["whole"], rank[i]["seq"]
        assert seq["loss"] == whole["loss"]
        np.testing.assert_array_equal(seq["per_client"], whole["per_client"])
        assert len(seq["grads"]) == len(whole["grads"])
        for j, (a, b) in enumerate(zip(seq["grads"], whole["grads"])):
            np.testing.assert_array_equal(a, b, err_msg=f"gradient leaf {j}")


def _stream_bytes(cfg, s):
    """(the bytes of one block's input on a rank, the layers it runs) for
    the body and, with an encoder, for the encoder: [B, S, D] f32, B this
    data rank's 2 clients x 2 sequences."""
    b = N // MESH.shape["data"] * BN
    out = [(b * _seq(cfg, s) * cfg.d_model * 4, cfg.num_layers)]
    if cfg.encoder_layers:
        out.append((b * cfg.encoder_seq * cfg.d_model * 4,
                    cfg.encoder_layers))
    return out


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_saved_bytes_fall_by_the_slices(world, i):
    """The forward's saved tensors fall by (m - 1) / m of each block's
    input (the remat checkpoint's stash), and by nothing where the
    sequence does not divide the axis."""
    _, kw, s = CASES[i]
    cfg = W._config(kw)
    m = MESH.shape["model"]
    want = sum(n * layers * (m - 1) // m for n, layers in
               _stream_bytes(cfg, s)) if _divides(cfg, s) else 0
    assert want > 0 or not _divides(cfg, s)
    for rank in world[1]:
        r = rank[i]
        assert r["whole"]["saved_bytes"] - r["seq"]["saved_bytes"] == want


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_collectives_the_cut_adds(world, i):
    """Each block all-gathers its input's slices (in the forward and the
    remat recompute) and its output's gradient (the cut's backward); the
    stream is cut once before the first block (its gradient gathered) and
    gathered once before the final norm: 3 L + 2 all-gathers over `model`
    a stack, each the whole block input's bytes. Nothing else moves."""
    _, kw, s = CASES[i]
    cfg = W._config(kw)
    calls = nbytes = 0
    if _divides(cfg, s):
        for n, layers in _stream_bytes(cfg, s):
            calls += 3 * layers + 2
            nbytes += (3 * layers + 2) * n
    for rank in world[1]:
        whole, seq = rank[i]["whole"]["counts"], rank[i]["seq"]["counts"]
        key = "all_gather/model"
        base = whole.get(key, {"calls": 0, "bytes": 0})
        got = seq.get(key, {"calls": 0, "bytes": 0})
        assert got["calls"] - base["calls"] == calls
        assert got["bytes"] - base["bytes"] == nbytes
        assert {k: v for k, v in seq.items() if k != key} == \
            {k: v for k, v in whole.items() if k != key}


def _jrun(cfg):
    mp = MPSLConfig(n_clients=N, trainable_blocks=1, head_adapter_rank=4,
                    compress_uplink=True, compress_downlink=True)
    return RunConfig(model=cfg, shape=SHAPES["train_4k"], mpsl=mp,
                     compute_dtype="float32", attn_impl="naive",
                     ce_impl="jnp", seq_shard_acts=True)


@pytest.fixture(scope="module")
def jax_losses(world):
    out = {}
    for i in JAX_CASES:
        kw, params, frozen, batch, _ = world[0][i]
        kw = dict(kw)
        cfg = reduced(get_config(kw.pop("arch")), **kw)
        loss_fn = jmpsl.make_lm_loss(cfg, _jrun(cfg))
        rng = jax.random.fold_in(jax.random.PRNGKey(9), 0)
        jb = {k: jnp.asarray(v, jnp.int32) if k in ("tokens", "labels")
              else jnp.asarray(v) for k, v in batch.items()}
        (loss, met), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, frozen, jb, rng)
        out[i] = {"loss": float(loss),
                  "per_client": np.asarray(met["per_client"]),
                  "grads": [np.asarray(x) for x in jax.tree_util.tree_leaves(
                      W.bridge.from_repro(jax.tree_util.tree_map(
                          np.asarray, grads)))]}
    return out


@pytest.mark.parametrize("i", JAX_CASES, ids=[CASES[i][0] for i in JAX_CASES])
def test_seq_model_matches_jax(world, jax_losses, i):
    want = jax_losses[i]
    for rank in world[1]:
        r = rank[i]["seq"]
        assert abs(r["loss"] - want["loss"]) <= LOSS_TOL * abs(want["loss"])
        np.testing.assert_allclose(r["per_client"], want["per_client"],
                                   rtol=LOSS_TOL)
        assert len(r["grads"]) == len(want["grads"])
        for j, (g, w) in enumerate(zip(r["grads"], want["grads"])):
            assert _rel_l2(g, w) <= GRAD_L2_TOL, f"gradient leaf {j}"


def test_prefill_under_seq_model_is_bitwise(world):
    """``steps.build_prefill`` with the flag (a prefill takes the same
    path: each block gathers its input whole and writes the caches from
    it): the last logits and every cache leaf bitwise those without it;
    the cut adds an all-gather a block and one before the final norm."""
    layers = W._config(QWEN).num_layers
    for rank in world[2]:
        whole, seq = rank[0]["whole"], rank[0]["seq"]
        key = "all_gather/model"
        assert seq["counts"][key] - whole["counts"].get(key, 0) == layers + 1
        np.testing.assert_array_equal(seq["logits"], whole["logits"])
        assert len(seq["cache"]) == len(whole["cache"]) > 0
        for a, b in zip(seq["cache"], whole["cache"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", WIDE)
@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_default_run_asks_for_seq_model_in_training(arch, multi_pod):
    """``train_4k`` at d_model >= 8192 sets the flag, as the JAX package's
    ``default_run`` does, and its impls ask for seq_model; the serving
    cells do not."""
    cfg = tget_config(arch)
    assert cfg.d_model >= 8192
    mesh = make_production_mesh(multi_pod=multi_pod)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        run = steps.default_run(cfg, TSHAPES[shape], mesh)
        # the JAX default_run reads the mesh's axis names and sizes only
        jrun = jsteps.default_run(get_config(arch), SHAPES[shape], mesh)
        assert run.seq_shard_acts == jrun.seq_shard_acts \
            == (shape == "train_4k")
        assert run.impls["act_dims"] == (
            TM.SEQ_MODEL if shape == "train_4k" else ("batch", None, None))
