"""The per-rank functions of the mesh tests (``tests/test_torch_mesh_*.py``).

``launch.spmd.spawn`` starts a fresh process a rank, which imports the
function it runs by its module: this one imports torch and the port only
(no jax), so a rank starts in a few seconds. Each function runs with the
rank's program active, takes numpy inputs (the whole arrays; each rank
cuts its own shards) and returns numpy results, gathered back to whole
arrays where the test compares them."""
from __future__ import annotations

import hashlib

import numpy as np
import torch

import dataclasses

from repro_torch import bridge, tree
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.io import snapshot
from repro_torch.configs import (MPSLConfig, RunConfig, ShapeConfig,
                                 get_config, reduced)
from repro_torch.core import (aggregation, baselines, compression, losses,
                              mpsl, split)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve, steps, train
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.optim import schedules
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding


def port_config(arch, **kw):
    return reduced(get_config(arch), **kw)


def _config(cfg_kw):
    """The reduced config of ``cfg_kw``'s "arch" (minitron-4b by default)
    with the rest of its keys as overrides."""
    kw = dict(cfg_kw)
    return port_config(kw.pop("arch", "minitron-4b"), **kw)


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


def _gathered(local, params_local=None):
    """Whole numpy leaves of a local tree (by each leaf's own spec, or the
    spec of the matching leaf of `params_local`)."""
    if params_local is None:
        return [_np(sharding.gather_leaf(x)) for x in tree.leaves(local)]
    return [_np(sharding.gather_leaf(g, C.spec_of(p)))
            for g, p in zip(local, tree.leaves(params_local))]


def _with_meshes(meshes, fn, *args):
    """fn(*args) under a program on each mesh (all of this world's size),
    in order: {mesh.name: result}."""
    out = {}
    dev = C.active().device
    for m in meshes:
        with C.program(mesh_lib.init_device_mesh(m, dev)):
            out[m.name] = fn(*args)
    return out


# ---------------------------------------------------------------------------
# layouts and the autograd pairs


def roundtrip(trees):
    """{name: {"shapes", "specs", "equal"}}: each tree cut by
    ``param_specs`` on the active mesh and gathered back."""
    prog = C.active()
    out = {}
    for name, t in trees.items():
        params = bridge.from_repro(t)
        specs = sharding.param_specs(params, prog.mesh)
        local = sharding.shard_tree(params, specs)
        back = sharding.gather_tree(local)
        out[name] = {
            "shapes": [tuple(x.shape) for x in tree.leaves(local)],
            "specs": [C.spec_of(x) for x in tree.leaves(local)],
            "equal": all(torch.equal(a, b) for a, b in zip(
                tree.leaves(params), tree.leaves(back)))}
    return out


def pairs():
    """The three autograd pairs on every axis: values and gradients."""
    out = {}
    for axis in ("data", "model"):
        n, i = C.size(axis), C.index(axis)
        x = torch.ones(3, requires_grad=True)
        (C.copy_to(x, axis) * (i + 1)).sum().backward()
        y = torch.full((3,), float(i + 1), requires_grad=True)
        r = C.reduce_from(y, axis)
        r.sum().backward()
        z = (torch.arange(6.).reshape(2, 3) + 10 * i).requires_grad_()
        g = C.gather_from(z, 0, axis)
        w = torch.arange(2. * n * 3).reshape(2 * n, 3)
        (g * w).sum().backward()
        out[axis] = {"n": n, "i": i, "copy_grad": x.grad.numpy(),
                     "reduce": r.detach().numpy(),
                     "reduce_grad": y.grad.numpy(),
                     "gather": g.detach().numpy(),
                     "gather_grad": z.grad.numpy()}
    return out


# ---------------------------------------------------------------------------
# one dense block, the vocab-parallel CE, quant8's row0


def block(cfg_kw, block_np, x_np, pos_np, cot_np):
    """A dense block's output and gradients (x's and every param's,
    gathered) under the active program."""
    cfg = port_config("minitron-4b", **cfg_kw)
    prog = C.active()
    params = bridge.from_repro(block_np)
    local = sharding.shard_tree(params, sharding.param_specs(params,
                                                             prog.mesh))
    for p in tree.leaves(local):
        p.requires_grad_(True)
    x = torch.from_numpy(x_np).requires_grad_()
    y, _, _ = M.apply_block(local, x, cfg, M.BlockKind("dense"),
                            positions=torch.from_numpy(pos_np),
                            impls={"attn": "kernel"})
    (y * torch.from_numpy(cot_np)).sum().backward()
    grads = [p.grad for p in tree.leaves(local)]
    return {"y": _np(y), "dx": _np(x.grad),
            "grads": _gathered(grads, local)}


def vocab_ce(h_np, w_np, labels_np, g_np):
    """The CE of h against lm_head w (laid out by the rule table) through
    ``losses.chunked_softmax_xent`` (the kernel route: its plain version
    on the CPU): losses, dh and the gathered dw."""
    prog = C.active()
    w_full = torch.from_numpy(w_np)
    spec = sharding.param_specs({"lm_head": w_full}, prog.mesh)["lm_head"]
    w = sharding.shard_leaf(w_full, spec).requires_grad_()
    h = torch.from_numpy(h_np).requires_grad_()
    loss = losses.chunked_softmax_xent(h, w, torch.from_numpy(labels_np),
                                       impl="kernel")
    loss.backward(torch.from_numpy(g_np))
    return {"loss": _np(loss), "dh": _np(h.grad),
            "dw": _np(sharding.gather_leaf(w.grad, spec)), "spec": spec}


def quant_links(x_np, g_np, seed):
    """This data rank's clients of the stacked link activations x [N, Bn,
    S, D] through both links (``core.compression``, Philox under a
    generator of `seed`, row0 = the rank's first row), gathered: the
    uplink's value and the downlink's quantised cotangent g."""
    n = x_np.shape[0] // C.size("data")
    c0 = C.index("data") * n
    rows = int(np.prod(x_np.shape[1:-1]))
    x = torch.from_numpy(x_np[c0:c0 + n]).requires_grad_()
    up = compression.compress_activations(
        x, torch.Generator().manual_seed(seed), row0=c0 * rows)
    down = compression.compress_gradients(
        x, torch.Generator().manual_seed(seed + 1), row0=c0 * rows)
    down.backward(torch.from_numpy(g_np[c0:c0 + n]))
    return {"up": _np(C.all_gather(up.detach(), 0, "data")),
            "down": _np(C.all_gather(x.grad, 0, "data"))}


def layer_cases(meshes, trees, block_args, ce_args, quant_args):
    """On each mesh: the round trip of `trees`, the pairs, and (on a data
    axis of 1: the inputs are the same on every rank) the dense block at a
    model axis of 2 and the CE at any model axis above 1, (on a data axis
    above 1) quant8's links."""
    def one():
        prog = C.active()
        out = {"trip": roundtrip(trees), "pairs": pairs()}
        if prog.mesh.shape["data"] == 1 and prog.mesh.shape["model"] == 2:
            out["block"] = block(*block_args)
        if prog.mesh.shape["data"] == 1 and prog.mesh.shape["model"] > 1:
            out["ce"] = vocab_ce(*ce_args)
        if prog.mesh.shape["data"] > 1:
            out["quant"] = quant_links(*quant_args)
        return out
    return _with_meshes(meshes, one)


# ---------------------------------------------------------------------------
# the MPSL step and serving


def _port_run(cfg, n_clients, compress):
    mp = MPSLConfig(n_clients=n_clients, trainable_blocks=1,
                    head_adapter_rank=4, compress_uplink=compress,
                    compress_downlink=compress)
    return RunConfig(model=cfg, shape=None, mpsl=mp, compute_dtype="float32",
                     attn_impl="kernel", ce_impl="kernel", ssm_impl="kernel")


def _batch(batch_np, prog):
    b = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    return sharding.shard_tree(b, sharding.batch_specs(b, prog.mesh))


def mpsl_step(cfg_kw, params_np, frozen_np, batch_np, draws_np, lr,
              ckpt_dir=None):
    """Under the active program: the MPSL loss and every gradient (this
    rank's part, summed over the client axis by ``reduce_grads``,
    gathered), then one ``make_train_step`` (the loss fed `draws_np`, the
    JAX uniforms of both links) and the gathered state after it; with
    `ckpt_dir`, that state saved there as step 1's checkpoint (every rank
    gathers, rank 0 writes) and its whole leaves by path."""
    cfg = _config(cfg_kw)
    prog = C.active()
    run = _port_run(cfg, batch_np["mask"].shape[0], True)
    state = mpsl.init_state(bridge.from_repro(params_np),
                            bridge.from_repro(frozen_np), seed=9)
    state = mpsl.place_state(state)
    batch = _batch(batch_np, prog)
    draws = {k: torch.from_numpy(v) for k, v in draws_np.items()}
    loss_fn = mpsl.make_lm_loss(cfg, run)
    C.reset_counts()
    loss, met, grads = mpsl.value_and_grad(loss_fn, state["params"],
                                           state["frozen"], batch, draws)
    C.reduce_grads(tree.leaves(state["params"]), grads)
    counts = C.read_counts()
    out = {"loss": float(loss), "per_client": _np(met["per_client"]),
           "participating": float(met["participating"]),
           "grads": _gathered(grads, state["params"]), "counts": counts,
           "specs": [C.spec_of(p) for p in tree.leaves(state["params"])]}
    step = mpsl.make_train_step(
        lambda p, f, bb, _rng: loss_fn(p, f, bb, draws), run,
        schedules.constant(lr))
    state, met = step(state, batch)
    out.update(step_loss=float(met["loss"]),
               grad_norm=float(met["grad_norm"]),
               params=_gathered(state["params"]),
               mu=_gathered(state["opt"]["mu"]),
               nu=_gathered(state["opt"]["nu"]),
               count=int(state["opt"]["count"]))
    if ckpt_dir is not None:
        host = snapshot(state)
        if prog.rank == 0:
            save_checkpoint(ckpt_dir, 1, host)
        torch.distributed.barrier()
        out["saved"] = _whole(host)
    return out


def _whole(state):
    """{path: numpy leaf} of a whole state's tensor leaves."""
    return {p: _np(x) for p, x in zip(tree.paths(state), tree.leaves(state))
            if torch.is_tensor(x)}


def restored(cfg_kw, params_np, frozen_np, directory):
    """A train state of `params_np` / `frozen_np` laid out on the active
    program (or whole, with none), restored in place from `directory`'s
    step 1 checkpoint and gathered: its whole leaves by path."""
    state = mpsl.place_state(mpsl.init_state(
        bridge.from_repro(params_np), bridge.from_repro(frozen_np), seed=9))
    state, _ = restore_checkpoint(directory, state, 1)
    return _whole(sharding.gather_tree(state))


def adapter_grads(cfg_kw, params_np, frozen_np, batches_np):
    """The adapter gradients (gathered, [N, ...]) of each batch, links
    off, rng 0."""
    cfg = _config(cfg_kw)
    prog = C.active()
    run = _port_run(cfg, batches_np[0]["mask"].shape[0], False)
    state = mpsl.place_state(mpsl.init_state(
        bridge.from_repro(params_np), bridge.from_repro(frozen_np)))
    loss_fn = mpsl.make_lm_loss(cfg, run)
    out = []
    for b in batches_np:
        loss, _, grads = mpsl.value_and_grad(
            loss_fn, state["params"], state["frozen"], _batch(b, prog), 0)
        full = _gathered(grads, state["params"])
        paths = tree.paths(state["params"])
        out.append({"loss": float(loss),
                    "adapter": {p: g for p, g in zip(paths, full)
                                if "adapter" in p}})
    return out


def step_cases(meshes, step_args, prop_args, serve_args):
    """On each mesh: the MPSL step, and (with a model axis above 1)
    ``adapter_grads`` of each of `prop_args` and serving."""
    def one():
        out = {"step": mpsl_step(*step_args)}
        if C.size("model") > 1:
            out["props"] = [adapter_grads(*a) for a in prop_args]
            out["serve"] = served(*serve_args)
        return out
    return _with_meshes(meshes, one)


def served(cfg_kw, params_np, tokens_np, steps_):
    """Prefill + greedy decode steps of ``launch.serve`` on this rank's
    shards (the TP-only serving layout: weights on `model`, replicated
    over `data` and `pod`; the batch on the client axis, `data` or (pod,
    data)): every step's logits and tokens, gathered."""
    cfg = _config(cfg_kw)
    prog = C.active()
    params = bridge.from_repro(params_np)
    params = sharding.shard_tree(params, steps._drop_fsdp(
        sharding.param_specs(params, prog.mesh)))
    tokens = torch.from_numpy(tokens_np)
    tokens = sharding.shard_leaf(tokens, sharding.resolve_spec(
        prog.mesh, tokens.shape, ("batch", None)))
    prefill, decode = serve.build_serving_fns(cfg, device="cpu",
                                              decode_slots=steps_ + 4)
    C.reset_counts()
    out = serve.generate(prefill, decode, params, tokens, steps_)
    counts = C.read_counts()
    logits = C.all_gather(out["logits"], 2, "model")
    rows = C.client_axis()
    return {"logits": _np(C.all_gather(logits, 0, rows)),
            "tokens": _np(C.all_gather(out["tokens"], 0, rows)),
            "counts": counts}


# ---------------------------------------------------------------------------
# expert parallelism


def moe_config(moe_kw):
    from repro_torch.configs import MoEConfig
    return port_config("qwen3-moe-235b-a22b", moe=MoEConfig(**moe_kw))


def ep_layer(moe_kw, moe_np, x_np, capacity):
    """``apply_moe(impl="ep")`` under the active program: this rank's
    tokens (x [B, S, D], batch on `data`) and experts (on `model`): the
    output gathered, and the routing's drop mask."""
    cfg = moe_config(moe_kw)
    prog = C.active()
    params = bridge.from_repro(moe_np)
    specs = sharding.param_specs({"moe": params}, prog.mesh)["moe"]
    local = sharding.shard_tree(params, specs)
    x = sharding.shard_leaf(torch.from_numpy(x_np), sharding.resolve_spec(
        prog.mesh, x_np.shape, ("batch", None, None)))
    with moe.routing_tape() as tape, torch.no_grad():
        y, aux = moe.apply_moe(local, x, cfg, impl="ep", capacity=capacity)
    drop = moe.ep_drop_mask(tape.idx[0], cfg.moe.num_experts, capacity)
    return {"y": _np(C.all_gather(y, 0, "data")), "aux": float(aux),
            "drop": _np(C.all_gather(drop, 0, "data")),
            "specs": {k: C.spec_of(v) for k, v in local.items()}}


def ep_cases(meshes, cases):
    """{mesh name: [ep_layer(*args) for each of `cases`]}."""
    return _with_meshes(meshes, lambda: [ep_layer(*a) for a in cases])


# ---------------------------------------------------------------------------
# the train CLI and its checkpoints


def cli(argv):
    """``launch.train.main(argv)`` on this rank: (exit code, the summary
    line, or None on a rank that prints none)."""
    import contextlib
    import io
    import json
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    lines = [x for x in buf.getvalue().splitlines() if x.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None)


def restore(argv, directory, step):
    """The train CLI's state (``train.build``) restored from `directory`'s
    checkpoint `step` onto this rank's shards (in one process with no
    program: the whole state), gathered whole."""
    args = train.parser().parse_args(argv)
    _, _, state, _, _ = train.build(args, torch.device("cpu"))
    restored, _ = restore_checkpoint(directory, state, step)
    return {p: _np(sharding.gather_leaf(x))
            for p, x in zip(tree.paths(restored), tree.leaves(restored))
            if torch.is_tensor(x)}


# ---------------------------------------------------------------------------
# the Mamba and hybrid families (tests/test_torch_mesh_ssm.py)


def shards(trees):
    """{name: {"local", "specs", "equal"}}: each tree cut by
    ``param_specs`` on the active mesh (this rank's shard of every leaf,
    numpy, and its spec) and whether ``gather_tree`` gives it back."""
    prog = C.active()
    out = {}
    for name, t in trees.items():
        params = bridge.from_repro(t)
        local = sharding.shard_tree(params,
                                    sharding.param_specs(params, prog.mesh))
        back = sharding.gather_tree(local)
        out[name] = {
            "local": [_np(x) for x in tree.leaves(local)],
            "specs": [C.spec_of(x) for x in tree.leaves(local)],
            "equal": all(torch.equal(a, b) for a, b in zip(
                tree.leaves(params), tree.leaves(back)))}
    return out


def _rows(x_np):
    """This data rank's rows of a whole [B, ...] array (batch on `data`)."""
    t = torch.from_numpy(np.ascontiguousarray(x_np))
    return sharding.shard_leaf(t, sharding.resolve_spec(
        C.active().mesh, t.shape, ("batch",) + (None,) * (t.dim() - 1)))


def mesh_block(cfg_kw, kind, block_np, x_np, pos_np, cot_np, enc_np=None):
    """One block of kind `kind` under the active program, the batch on
    `data`: a Mamba or hybrid block (a global ``M.BlockKind(kind)``), a
    whisper encoder block ("enc", bidirectional) or decoder block ("dec":
    causal self-attention, then cross-attention over `enc_np`), a dense
    block (qwen2-vl's under M-RoPE positions [B, 3, S]). Its output, x's
    and the encoder output's gradients (gathered over `data`), and every
    param's gradient (summed over `data` by ``reduce_grads``,
    gathered)."""
    cfg = _config(cfg_kw)
    prog = C.active()
    params = bridge.from_repro(block_np)
    local = sharding.shard_tree(params,
                                sharding.param_specs(params, prog.mesh))
    leaves = tree.leaves(local)
    for p in leaves:
        p.requires_grad_(True)
    x = _rows(x_np).requires_grad_()
    enc = None if enc_np is None else _rows(enc_np).requires_grad_()
    bk = M.BlockKind(kind, causal=kind != "enc", cross=kind == "dec")
    y, _, _ = M.apply_block(local, x, cfg, bk, positions=_rows(pos_np),
                            enc_out=enc,
                            impls={"attn": "kernel", "ssm": "kernel",
                                   "ssm_chunk": 8})
    (y * _rows(cot_np)).sum().backward()
    grads = [p.grad for p in leaves]
    C.reduce_grads(leaves, grads)
    out = {"y": _np(C.all_gather(y.detach(), 0, "data")),
           "dx": _np(C.all_gather(x.grad, 0, "data")),
           "grads": _gathered(grads, local)}
    if enc is not None:
        out["denc"] = _np(C.all_gather(enc.grad, 0, "data"))
    return out


def _kv_caches(cache):
    """The KV caches of a body cache, in layer order."""
    return [layer["kv"] if "kv" in layer else layer
            for seg in cache for layer in seg if "pos" in layer
            or "kv" in layer]


def ssm_served(cfg_kw, params_np, tokens_np, steps_, slots, stub_np=None):
    """``launch.serve``'s prefill and `steps_` greedy decode steps on this
    rank's shards of the serving layout (``_drop_fsdp``: weights on
    `model`, the batch on `data`), `slots` decode slots, `stub_np` the
    whole frame or patch embeddings (this rank takes its rows): every
    step's logits and tokens (gathered), and before each decode step the
    fewest valid slots in any of this rank's KV caches (0: a shard holding
    only empty slots); with an encoder, each layer's cross K/V (kept by
    the prefill) gathered over `data`, its head count on this rank and
    whether every model rank holds the same bits."""
    cfg = _config(cfg_kw)
    prog = C.active()
    params = bridge.from_repro(params_np)
    params = sharding.shard_tree(params, steps._drop_fsdp(
        sharding.param_specs(params, prog.mesh)))
    tokens = _rows(tokens_np)
    stub = {k: _rows(v) for k, v in (stub_np or {}).items()}
    b, s = tokens.shape
    n_p = stub["patch_embeds"].shape[1] if "patch_embeds" in stub else None
    prefill, decode = serve.build_serving_fns(cfg, device="cpu",
                                              decode_slots=slots)
    logits, cache = prefill(params, tokens, **stub)
    decode.check_room(cache, steps_)
    kvs = _kv_caches(cache)
    out_logits, toks = [logits[:, -1]], [decode.greedy(logits[:, -1])]
    fewest = []
    for i in range(steps_):
        fewest.append(min((int((kv["pos"] >= 0).sum()) for kv in kvs),
                          default=None))
        logits, cache = decode(params, cache, toks[-1][:, None],
                               decode.positions(b, s, n_p, i))
        out_logits.append(logits[:, -1])
        toks.append(decode.greedy(logits[:, -1]))
    logits = torch.stack(out_logits, dim=1)
    if logits.shape[-1] != cfg.vocab_size:
        logits = C.all_gather(logits, 2, "model")
    out = {"logits": _np(C.all_gather(logits, 0, "data")),
           "tokens": _np(C.all_gather(torch.stack(toks, 1), 0, "data")),
           "fewest_valid": fewest,
           "kv_slots": [tuple(kv["k"].shape[1:3]) for kv in kvs],
           "kv_specs": [C.spec_of(kv["k"]) for kv in kvs]}
    crosses = [kv["cross"] for kv in kvs if "cross" in kv]
    if crosses:
        out["cross"] = [{n: _np(sharding.gather_leaf(c[n])) for n in c}
                        for c in crosses]
        out["cross_heads"] = [c["k"].shape[2] for c in crosses]
        out["cross_specs"] = [C.spec_of(c["k"]) for c in crosses]
        out["cross_same_on_model_ranks"] = all(
            all(torch.equal(part, c[n]) for part in C.all_gather(
                c[n][None], 0, "model").unbind(0))
            for c in crosses for n in ("k", "v"))
    return out


def merged(q_np, k_np, v_np, q_pos_np, k_pos_np, valid_np, window):
    """``attention._merged_attention`` of q over this model rank's slice
    of the slots of k, v (the kernel route: its plain version here)."""
    from repro_torch.models import attention
    spec = (None, "model", None, None)
    k, v = (sharding.shard_leaf(torch.from_numpy(a), spec)
            for a in (k_np, v_np))
    k_pos, valid = (sharding.shard_leaf(torch.from_numpy(a), spec[:2])
                    for a in (k_pos_np, valid_np))
    out = attention._merged_attention(
        torch.from_numpy(q_np), k, v, torch.from_numpy(q_pos_np), k_pos,
        True, window, valid, "kernel")
    return {"o": _np(out), "valid_here": valid.sum(-1).tolist()}


def prefill_cell(cfg_kw, params_np, tokens_np, stub_np=None):
    """``steps.build_prefill``'s function on this rank's shards of its
    in_specs (the rule table's layout: weights' D on `data` too, the
    batch on `data`; `stub_np` the whole frame or patch embeddings): the
    last logits and every cache leaf, gathered."""
    cfg = _config(cfg_kw)
    prog = C.active()
    b, s = tokens_np.shape
    stub = {k: torch.from_numpy(v) for k, v in (stub_np or {}).items()}
    if "patch_embeds" in stub:
        s += stub["patch_embeds"].shape[1]
    run = steps.default_run(cfg, ShapeConfig("prefill", s, b, "prefill"),
                            prog.mesh, attn_impl="kernel", ssm_impl="kernel",
                            compute_dtype="float32")
    fn, _, in_specs = steps.build_prefill(cfg, run, prog.mesh)
    params, batch = steps.shard_inputs(
        (bridge.from_repro(params_np),
         {"tokens": torch.from_numpy(tokens_np), **stub}), in_specs)
    logits, cache = fn(params, batch)
    whole = sharding.gather_tree(cache)
    if logits.shape[-1] != cfg.vocab_size:           # the vocab shards
        logits = C.all_gather(logits, 2, "model")
    return {"logits": _np(C.all_gather(logits, 0, "data")),
            "cache": {p: _np(x) for p, x in zip(tree.paths(whole),
                                                 tree.leaves(whole))
                      if torch.is_tensor(x)}}


def _cell_batch(cfg_kw):
    """A train cell's batch: 4 clients x 2 x 12 tokens, every client in;
    16 frames (audio) or 4 patches (vlm) a sample, 0.02 x N(0, 1)."""
    cfg = _config(cfg_kw)
    vocab = cfg.vocab_size
    rng = np.random.default_rng(8)
    out = {"tokens": rng.integers(0, vocab, (4, 2, 12)).astype(np.int32),
           "labels": rng.integers(0, vocab, (4, 2, 12)).astype(np.int32),
           "mask": np.ones(4, np.float32)}
    n = {"audio": cfg.encoder_seq, "vlm": 4}.get(cfg.family)
    if n:
        key = "frame_embeds" if cfg.family == "audio" else "patch_embeds"
        out[key] = (0.02 * rng.standard_normal(
            (4, 2, n, cfg.d_model))).astype(np.float32)
    return out


def _train_cell_run(cfg, mesh, n_clients, seq, **over):
    """The train cell's RunConfig for `seq` text tokens (a VLM cell's
    shape counts the 256 patches of ``train_batch_specs`` as well: the
    specs read only its batch's ranks, the batch may hold fewer); `over`
    overrides more of ``default_run``'s fields."""
    if cfg.family == "vlm":
        seq += steps.VLM_PATCH_TOKENS
    return steps.default_run(cfg, ShapeConfig("train", seq, 2 * n_clients,
                                              "train"), mesh,
                             n_clients=n_clients, trainable_blocks=1,
                             attn_impl="kernel", ssm_impl="kernel",
                             ce_impl="kernel", compute_dtype="float32",
                             **over)


def train_cell(cfg_kw, n_clients, batch_np, seed):
    """Two steps of ``steps.build_train``'s function on this rank's shards
    of its in_specs (the state drawn whole from `seed` by the port's
    init): each step's loss and grad norm."""
    cfg = _config(cfg_kw)
    prog = C.active()
    run = _train_cell_run(cfg, prog.mesh, n_clients,
                          batch_np["tokens"].shape[-1])
    step_fn, _, _, in_specs = steps.build_train(cfg, run, prog.mesh)
    params, frozen, _ = split.init_mpsl_lm(
        torch.Generator().manual_seed(seed), cfg, run)
    state, batch = steps.shard_inputs(
        (mpsl.init_state(params, frozen, seed),
         {k: torch.from_numpy(v) for k, v in batch_np.items()}), in_specs)
    out = []
    for _ in range(2):
        state, met = step_fn(state, batch)
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return out


def ssm_cases(meshes, trees, blocks, steps_args, props, serves, merges,
              prefills):
    """On each mesh: the shards of `trees`, every block of `blocks`, the
    MPSL step of each of `steps_args`, (with a data axis above 1) the
    adapter gradients of each of `props`, (with a model axis above 1)
    serving each of `serves`, the merged attention of each of `merges`
    and the prefill cell of each of `prefills`."""
    def one():
        out = {"shards": shards(trees),
               "blocks": [mesh_block(*a) for a in blocks],
               "steps": [mpsl_step(*a) for a in steps_args]}
        if C.size("data") > 1:
            out["props"] = [[adapter_grads(*a) for a in p] for p in props]
        if C.size("model") > 1:
            out["serve"] = [ssm_served(*a) for a in serves]
            out["merged"] = [merged(*a) for a in merges]
            out["prefill"] = [prefill_cell(*a) for a in prefills]
            out["train_cell"] = [train_cell(kw, 4, _cell_batch(kw), 0)
                                 for kw, _, _ in prefills]
        return out
    return _with_meshes(meshes, one)


# ---------------------------------------------------------------------------
# the encoder-decoder and VLM stacks (tests/test_torch_mesh_encdec.py)


def decode_cell(cfg_kw, params_np, cache, ckv, tokens_np, pos_np, steps_):
    """`steps_` steps of ``steps.build_decode``'s function on this rank's
    shards of its in_specs (the whole `cache` and cross K/V `ckv` cut by
    them), each fed `tokens_np` [B, steps_] and positions from `pos_np`
    on: every step's logits and the cache after them, gathered."""
    cfg = _config(cfg_kw)
    prog = C.active()
    b, cache_len = tokens_np.shape[0], _kv_caches(cache)[0]["k"].shape[1]
    run = steps.default_run(cfg, ShapeConfig("decode", cache_len, b,
                                             "decode"), prog.mesh,
                            attn_impl="kernel", compute_dtype="float32")
    fn, _, in_specs, _ = steps.build_decode(cfg, run, prog.mesh)
    params, cache, ckv = steps.shard_inputs(
        (bridge.from_repro(params_np), cache, ckv), in_specs[:3])
    logits = []
    for i in range(steps_):
        tok, pos = (sharding.shard_leaf(torch.from_numpy(a), sp) for a, sp
                    in ((tokens_np[:, i:i + 1], in_specs[3]),
                        (pos_np + i, in_specs[4])))
        out, cache = fn(params, cache, ckv, tok, pos)
        if out.shape[-1] != cfg.vocab_size:
            out = C.all_gather(out, 2, "model")
        logits.append(_np(C.all_gather(out[:, -1], 0, "data")))
    whole = sharding.gather_tree(cache)
    return {"logits": np.stack(logits, 1),
            "cache": {p: _np(x) for p, x in zip(tree.paths(whole),
                                                 tree.leaves(whole))
                      if torch.is_tensor(x)}}


def encdec_cases(meshes, trees, blocks, steps_args, props, serves, prefills,
                 decodes):
    """On each mesh: the shards of `trees`, every block of `blocks`, the
    MPSL step of each of `steps_args`, (with a data axis above 1) the
    adapter gradients of each of `props`, (with a model axis above 1)
    serving each of `serves`, and the prefill, decode and train cells."""
    def one():
        out = {"shards": shards(trees),
               "blocks": [mesh_block(*a) for a in blocks],
               "steps": [mpsl_step(*a) for a in steps_args]}
        if C.size("data") > 1:
            out["props"] = [[adapter_grads(*a) for a in p] for p in props]
        if C.size("model") > 1:
            out["serve"] = [ssm_served(*a) for a in serves]
            out["prefill"] = [prefill_cell(*a) for a in prefills]
            out["decode"] = [decode_cell(*a) for a in decodes]
            out["train_cell"] = [train_cell(a[0], 4, _cell_batch(a[0]), 0)
                                 for a in prefills]
        return out
    return _with_meshes(meshes, one)


# ---------------------------------------------------------------------------
# the MoE layouts of the production meshes (tests/test_torch_mesh_moe.py)


def moe_layer(cfg_kw, moe_np, x_np, cot_np, impl, capacity=2.0):
    """``apply_moe(impl=impl)`` under the active program on the rule
    table's layout (the experts on `model` where the axis divides them,
    else each expert's F; D on `data`), the batch x [B, S, D] on `data`:
    y and x's gradient (gathered over `data`), aux, and every weight's
    gradient of sum(y * cot) + aux (summed over `data` by
    ``reduce_grads``, gathered), the weights' specs, and for each ragged
    call over a share of the experts the number of model ranks that ran
    each (token, k) slot."""
    cfg = _config(cfg_kw)
    prog = C.active()
    params = bridge.from_repro(moe_np)
    local = sharding.shard_tree(params, sharding.param_specs(
        {"moe": params}, prog.mesh)["moe"])
    leaves = tree.leaves(local)
    for p in leaves:
        p.requires_grad_(True)
    x = _rows(x_np).requires_grad_()
    with moe.routing_tape() as tape:
        y, aux = moe.apply_moe(local, x, cfg, impl=impl, capacity=capacity)
        ((y * _rows(cot_np)).sum() + aux).backward()
    grads = [p.grad for p in leaves]
    C.reduce_grads(leaves, grads)
    return {"y": _np(C.all_gather(y.detach(), 0, "data")),
            "aux": float(aux), "dx": _np(C.all_gather(x.grad, 0, "data")),
            "grads": _gathered(grads, local),
            "specs": {k: C.spec_of(v) for k, v in local.items()
                      if torch.is_tensor(v)},
            "ran": [_np(C.all_gather(C.all_reduce(h.int(), "model"), 0,
                                     "data")) for h in tape.hits]}


def moe_train_cell(cfg_kw, impl, batch_np, seed):
    """``steps.build_train``'s step (``default_run``'s RunConfig with the
    kernels and `impl` as its moe dispatch, 4 clients) on this rank's
    shards of its in_specs, the state drawn whole from `seed`: the loss,
    every client's loss and every gradient at the start (``make_lm_loss``
    of the same RunConfig, summed over `data` by ``reduce_grads``,
    gathered), then two steps (each one's loss, grad norm and collectives
    by op and axis) and the params after them, gathered."""
    cfg = _config(cfg_kw)
    prog = C.active()
    run = _train_cell_run(cfg, prog.mesh, 4, batch_np["tokens"].shape[-1],
                          moe_impl=impl)
    step_fn, _, _, in_specs = steps.build_train(cfg, run, prog.mesh)
    params, frozen, _ = split.init_mpsl_lm(
        torch.Generator().manual_seed(seed), cfg, run)
    state, batch = steps.shard_inputs(
        (mpsl.init_state(params, frozen, seed),
         {k: torch.from_numpy(v) for k, v in batch_np.items()}), in_specs)
    loss, met, grads = mpsl.value_and_grad(mpsl.make_lm_loss(cfg, run),
                                           state["params"], state["frozen"],
                                           batch, 0)
    C.reduce_grads(tree.leaves(state["params"]), grads)
    out = {"loss": float(loss), "per_client": _np(met["per_client"]),
           "grads": _gathered(grads, state["params"]), "steps": []}
    for _ in range(2):
        C.reset_counts()
        state, met = step_fn(state, batch)
        counts = C.read_counts()
        counts.pop("program", None)
        out["steps"].append({"loss": float(met["loss"]),
                             "grad_norm": float(met["grad_norm"]),
                             "counts": counts})
    out["params"] = _gathered(state["params"])
    return out


def moe_cases(meshes, layer_args, train_args, serve_args):
    """On each mesh: ``moe_layer`` of each of `layer_args`,
    ``moe_train_cell`` of each of `train_args` and ``ssm_served`` (the
    serve CLI's functions, ragged) of each of `serve_args`."""
    def one():
        return {"layer": [moe_layer(*a) for a in layer_args],
                "train": [moe_train_cell(*a) for a in train_args],
                "serve": [ssm_served(*a) for a in serve_args]}
    return _with_meshes(meshes, one)


# ---------------------------------------------------------------------------
# the per-client backward baseline (tests/test_torch_mesh_psl.py)


def _counted(fn, *args):
    """fn(*args) and the collectives it issued, {"op/axis": calls}."""
    C.reset_counts()
    out = fn(*args)
    return out, {k: v["calls"] for k, v in C.read_counts().items()
                 if k != "program"}


def psl_step(cfg_kw, params_np, frozen_np, batch_np, draws_np, lr):
    """Under the active program, from the same state: the aggregated
    loss's gradients (one ``value_and_grad``, then ``reduce_grads``), then
    one ``make_train_step(backward_mode="per_client")`` step (the loss fed
    `draws_np`, the JAX uniforms of both links, or links off where None):
    its loss, every client's loss, its gradients (summed over `data`,
    gathered; read by its grad hook) and the params after it, with the
    collectives of each part."""
    cfg = _config(cfg_kw)
    prog = C.active()
    run = _port_run(cfg, batch_np["mask"].shape[0], draws_np is not None)
    state = mpsl.place_state(mpsl.init_state(
        bridge.from_repro(params_np), bridge.from_repro(frozen_np), seed=9))
    batch = _batch(batch_np, prog)
    rng = 0 if draws_np is None else {k: torch.from_numpy(v)
                                      for k, v in draws_np.items()}
    loss_fn = mpsl.make_lm_loss(cfg, run)
    leaves = tree.leaves(state["params"])
    (_, _, agg), agg_counts = _counted(mpsl.value_and_grad, loss_fn,
                                       state["params"], state["frozen"],
                                       batch, rng)
    _, reduce_counts = _counted(C.reduce_grads, leaves, agg)
    seen = []
    step = mpsl.make_train_step(
        lambda p, f, bb, _rng: loss_fn(p, f, bb, rng), run,
        schedules.constant(lr), backward_mode="per_client",
        grad_hook=lambda _, g: seen.extend(x.clone() for x in g))
    (state, met), step_counts = _counted(step, state, batch)
    return {"agg_grads": _gathered(agg, state["params"]),
            "grads": _gathered(seen, state["params"]),
            "loss": float(met["loss"]), "per_client": _np(met["per_client"]),
            "participating": float(met["participating"]),
            "params": _gathered(state["params"]),
            "counts": {"value_and_grad": agg_counts,
                       "reduce_grads": reduce_counts, "step": step_counts}}


def psl_cases(meshes, cases):
    """{mesh name: [psl_step(*a) for a in `cases`]}."""
    return _with_meshes(meshes, lambda: [psl_step(*a) for a in cases])


# ---------------------------------------------------------------------------
# sequence-sharded activations (tests/test_torch_mesh_seq.py)


def _saved_bytes(fn):
    """fn() and the bytes of every tensor that autograd saved for the
    backward while it ran (a checkpoint's input counted once, nothing
    saved inside it)."""
    n = [0]

    def pack(t):
        n[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, n[0]


def seq_step(cfg_kw, params_np, frozen_np, batch_np, draws_np,
             flag="seq_shard_acts", base=()):
    """Under the active program, the MPSL loss and every gradient (summed
    over the client axis by ``reduce_grads``, gathered), links on the
    given draws (off where None), without and with the RunConfig field
    `flag` (``seq_shard_acts``: act_dims ("batch", "seq_model", None);
    ``attn_seq_shard``: the core attention over the rank's queries), the
    fields `base` set in both: for each ("whole", "seq"), the loss, the
    gradients, the bytes autograd saved over the forward and the
    collectives of the forward and backward, {"op/axis": {"calls",
    "bytes"}}."""
    cfg = _config(cfg_kw)
    prog = C.active()
    draws = 0 if draws_np is None else {k: torch.from_numpy(v)
                                        for k, v in draws_np.items()}
    out = {}
    for seq in (False, True):
        run = dataclasses.replace(
            _port_run(cfg, batch_np["mask"].shape[0], draws_np is not None),
            **dict(base), **{flag: seq})
        state = mpsl.place_state(mpsl.init_state(
            bridge.from_repro(params_np), bridge.from_repro(frozen_np),
            seed=9))
        batch = _batch(batch_np, prog)
        loss_fn = mpsl.make_lm_loss(cfg, run)
        leaves = tree.leaves(state["params"])
        C.reset_counts()
        (loss, met), saved = _saved_bytes(
            lambda: loss_fn(state["params"], state["frozen"], batch, draws))
        grads = mpsl.grad(loss, leaves)
        counts = {k: v for k, v in C.read_counts().items()
                  if k != "program"}
        C.reduce_grads(leaves, grads)
        out["seq" if seq else "whole"] = {
            "loss": float(met["loss"]), "per_client": _np(met["per_client"]),
            "grads": _gathered(grads, state["params"]),
            "saved_bytes": saved, "counts": counts}
    return out


def seq_prefill(cfg_kw, params_np, tokens_np, flag="seq_shard_acts"):
    """``steps.build_prefill``'s function on this rank's shards, without
    and with the RunConfig field `flag` (``seq_shard_acts``: the stream
    cut between the blocks, the cache written by each block from the
    whole sequence; ``attn_seq_shard``: the core over the rank's
    queries): for each, the last logits and every cache leaf, gathered,
    and the collectives of the call."""
    cfg = _config(cfg_kw)
    prog = C.active()
    b, s = tokens_np.shape
    out = {}
    for seq in (False, True):
        run = steps.default_run(cfg, ShapeConfig("prefill", s, b, "prefill"),
                                prog.mesh, attn_impl="kernel",
                                compute_dtype="float32", **{flag: seq})
        fn, _, in_specs = steps.build_prefill(cfg, run, prog.mesh)
        params, batch = steps.shard_inputs(
            (bridge.from_repro(params_np),
             {"tokens": torch.from_numpy(tokens_np)}), in_specs)
        (logits, cache), counts = _counted(fn, params, batch)
        whole = sharding.gather_tree(cache)
        out["seq" if seq else "whole"] = {
            "counts": counts,
            "logits": _np(sharding.gather_leaf(logits, ("data", None,
                                                        "model"))),
            "cache": [_np(x) for x in tree.leaves(whole)
                      if torch.is_tensor(x)]}
    return out


def seq_cases(meshes, cases, prefills=()):
    """{mesh name: ([seq_step(*a) for a in `cases`], [seq_prefill(*a) for
    a in `prefills`])}."""
    return _with_meshes(meshes, lambda: ([seq_step(*a) for a in cases],
                                         [seq_prefill(*a) for a in prefills]))


# ---------------------------------------------------------------------------
# the dry run's program trace (tests/test_torch_dryrun_program.py)


def dry_step(kind, cfg_kw, seq, batch, over, mesh):
    """(fn, abstract whole arguments, in_specs) of a dry-run cell's step on
    `mesh`: ``steps.default_run``'s run for `kind` at `seq` tokens and
    global batch `batch`, `over` overriding its fields, the scan in its
    associative form (as ``launch.dryrun.run_cell`` traces it)."""
    cfg = _config(cfg_kw)
    shape = ShapeConfig(kind, seq, batch, kind)
    run = dataclasses.replace(
        steps.default_run(cfg, shape, mesh, compute_dtype="float32", **over),
        ssm_impl="assoc")
    if kind == "train":
        fn, a_state, a_batch, specs = steps.build_train(cfg, run, mesh)
        return fn, (a_state, a_batch), specs
    if kind == "prefill":
        return steps.build_prefill(cfg, run, mesh)
    return steps.build_decode(cfg, run, mesh)[:3]


def _real(tree_, seed):
    """A tree of meta leaves as real tensors, drawn from `seed`: ints in
    [0, 8), floats 0.02 x N(0, 1), a train batch's mask ones."""
    gen = torch.Generator().manual_seed(seed)

    def real(x):
        if not torch.is_tensor(x):
            return x
        if x.dtype in (torch.int32, torch.int64):
            return torch.randint(0, 8, x.shape, dtype=x.dtype, generator=gen)
        return (0.02 * torch.randn(x.shape, generator=gen)).to(x.dtype)
    out = tree.map_(real, tree_)
    if isinstance(out, tuple) and isinstance(out[-1], dict) \
            and "mask" in out[-1]:
        out[-1]["mask"] = torch.ones_like(out[-1]["mask"])
    return out


def dry_cases(worlds):
    """For each (mesh, cases) of `worlds`, under a program on the mesh,
    each ``dry_step(*case)`` run once on this rank's shards of real
    arguments: {mesh name: [its collectives, {"op/axis": {"calls",
    "bytes"}}, and its ``FlopCounterMode`` flops]}."""
    from torch.utils.flop_counter import FlopCounterMode
    out = {}
    dev = C.active().device
    for m, cases in worlds:
        with C.program(mesh_lib.init_device_mesh(m, dev)):
            res = []
            for case in cases:
                fn, a_args, specs = dry_step(*case, m)
                args = steps.shard_inputs(_real(a_args, 3), specs)
                C.reset_counts()
                with FlopCounterMode(display=False) as fc:
                    fn(*args)
                res.append({"flops": fc.get_total_flops(),
                            "counts": {k: v for k, v in
                                       C.read_counts().items()
                                       if k != "program"}})
            out[m.name] = res
    return out


# ---------------------------------------------------------------------------
# the pod axis (tests/test_torch_mesh_pod.py)


def pod_cases(meshes, step_args, prop_args, serve_args, ckpt_dir):
    """On each mesh: the MPSL step (its collectives, and on the first mesh
    its state saved in `ckpt_dir` unless None), the adapter gradients of
    each of `prop_args` and serving."""
    first = meshes[0].name

    def one():
        kw = {"ckpt_dir": ckpt_dir} if C.active().mesh.name == first \
            else {}
        return {"step": mpsl_step(*step_args, **kw),
                "props": [adapter_grads(*a) for a in prop_args],
                "serve": served(*serve_args)}
    return _with_meshes(meshes, one)


# ---------------------------------------------------------------------------
# the program's sums in float64 (tests/test_torch_mesh_f64.py)


def f64_grads(cfg_kw, params_np, frozen_np, batch_np):
    """The MPSL loss's gradients (links off, the plain impls) in float64:
    every param cast to f64, compute_dtype "float64", and ``Tensor.float``
    giving f64 while the loss and its backward run, so that the model
    code's f32 upcasts hold f64 too. Under a program, summed by
    ``reduce_grads`` and gathered; {path: numpy gradient}."""
    cfg = _config(cfg_kw)
    prog = C.active()
    run = dataclasses.replace(_port_run(cfg, batch_np["mask"].shape[0],
                                        False), compute_dtype="float64")
    f64 = lambda t: t.double()                      # noqa: E731
    state = mpsl.place_state(mpsl.init_state(
        tree.map_(f64, bridge.from_repro(params_np)),
        tree.map_(f64, bridge.from_repro(frozen_np))))
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    if prog is not None:
        batch = sharding.shard_tree(batch, sharding.batch_specs(batch,
                                                                prog.mesh))
    loss_fn = mpsl.make_lm_loss(cfg, run, impls={
        "attn": "naive", "ssm": "plain", "ce": "plain", "ssm_chunk": 8})
    as_float = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        _, _, grads = mpsl.value_and_grad(loss_fn, state["params"],
                                          state["frozen"], batch, 0)
    finally:
        torch.Tensor.float = as_float
    C.reduce_grads(tree.leaves(state["params"]), grads)
    whole = _gathered(grads, state["params"]) if prog is not None \
        else [_np(g) for g in grads]
    return dict(zip(tree.paths(state["params"]), whole))


# ---------------------------------------------------------------------------
# the paper's ViT mode (tests/test_torch_mesh_vit.py)

# (task, fusion, modalities): late fusion runs three encoder passes
VIT_CASES = {"early": ("classification", "early", ("vision", "text")),
             "late": ("classification", "late", ("vision", "audio", "text")),
             "retrieval": ("retrieval", "early", ("vision", "text"))}
# the text tokenizer's table [N, 49408, D] is returned cut to its first
# rows (its gradient is held whole on each rank: exactly 0)
TEXT_ROWS = 256


def _vit_run(cfg, n_clients, fusion, compress):
    mp = MPSLConfig(n_clients=n_clients, trainable_blocks=1, fusion=fusion,
                    compress_uplink=compress, compress_downlink=compress)
    return RunConfig(model=cfg, shape=None, mpsl=mp, compute_dtype="float32",
                     attn_impl="kernel", ce_impl="kernel")


def _vit_state(params_np, frozen_np):
    return mpsl.place_state(mpsl.init_state(
        bridge.from_repro(params_np), bridge.from_repro(frozen_np), seed=9))


def _vit_gathered(local, params_local):
    """Whole numpy leaves of `local` (leaves shaped as `params_local`'s,
    by their specs); the text table cut to its first TEXT_ROWS rows."""
    out = []
    for path, g, p in zip(tree.paths(params_local), local,
                          tree.leaves(params_local)):
        x = sharding.gather_leaf(g, C.spec_of(p))
        out.append(_np(x[:, :TEXT_ROWS] if path.endswith("text/embed")
                       else x))
    return out


def _text_table_max(local, params_local) -> float:
    """The largest |element| of this rank's text-table leaf of `local`."""
    return max([float(g.abs().max()) for path, g in zip(
        tree.paths(params_local), local) if path.endswith("text/embed")]
        or [0.0])


def _placed(batch_np, prog):
    """``place_batch`` on the mesh: each leaf's local shape and whether it
    holds exactly this client rank's clients of the host batch."""
    placed = sharding.place_batch(batch_np, "cpu", prog.mesh)
    axis = C.client_axis()
    n = batch_np["mask"].shape[0] // C.size(axis)
    c0 = C.index(axis) * n
    return {k: (tuple(v.shape), bool(torch.equal(
        v, torch.from_numpy(np.ascontiguousarray(batch_np[k][c0:c0 + n]))
        .to(v.dtype)))) for k, v in placed.items()}


def vit_step(cfg_kw, case, n_classes, params_np, frozen_np, batch_np,
             draws_np=None, lr=None):
    """Under the active program: the vit MPSL loss of `case` (both links
    int8 on the given uniforms where `draws_np` is given, else off) and
    every gradient (this rank's part, summed by ``reduce_grads``,
    gathered), the leaves' specs, the placed batch; with `lr`, one
    ``make_train_step`` and the state after it, gathered."""
    cfg = _config(cfg_kw)
    prog = C.active()
    task, fusion, mods = VIT_CASES[case]
    run = _vit_run(cfg, batch_np["mask"].shape[0], fusion,
                   draws_np is not None)
    state = _vit_state(params_np, frozen_np)
    params = state["params"]
    batch = _batch(batch_np, prog)
    rng = 0 if draws_np is None else {
        link: {d: torch.from_numpy(u) for d, u in v.items()}
        for link, v in draws_np.items()}
    loss_fn = mpsl.make_vit_loss(cfg, run, modalities=mods, task=task,
                                 n_classes=n_classes)
    C.reset_counts()
    loss, met, grads = mpsl.value_and_grad(loss_fn, params, state["frozen"],
                                           batch, rng)
    C.reduce_grads(tree.leaves(params), grads)
    out = {"loss": float(loss), "per_client": _np(met["per_client"]),
           "participating": float(met["participating"]),
           "grads": _vit_gathered(grads, params),
           "text_grad_max": _text_table_max(grads, params),
           "counts": C.read_counts(),
           "specs": [C.spec_of(p) for p in tree.leaves(params)],
           "frozen_specs": [C.spec_of(p)
                            for p in tree.leaves(state["frozen"])],
           "placed": _placed(batch_np, prog)}
    if lr is not None:
        step = mpsl.make_train_step(
            lambda p, f, bb, _rng: loss_fn(p, f, bb, rng), run,
            schedules.constant(lr))
        state, met = step(state, batch)
        params = state["params"]
        out.update(step_loss=float(met["loss"]),
                   grad_norm=float(met["grad_norm"]),
                   params=_vit_gathered(tree.leaves(params), params),
                   mu=_vit_gathered(tree.leaves(state["opt"]["mu"]), params),
                   nu=_vit_gathered(tree.leaves(state["opt"]["nu"]), params),
                   text_moments_max=max(
                       _text_table_max(tree.leaves(state["opt"][k]), params)
                       for k in ("mu", "nu")),
                   count=int(state["opt"]["count"]))
    return out


def vit_tokenizer_grads(cfg_kw, n_classes, params_np, frozen_np, batches_np):
    """The tokenizers' gradients (gathered, [N, ...]; the text table
    apart) of each early-fusion batch, links off."""
    cfg = _config(cfg_kw)
    prog = C.active()
    run = _vit_run(cfg, batches_np[0]["mask"].shape[0], "early", False)
    state = _vit_state(params_np, frozen_np)
    loss_fn = mpsl.make_vit_loss(cfg, run, n_classes=n_classes)
    paths = tree.paths(state["params"])
    out = []
    for b in batches_np:
        _, _, grads = mpsl.value_and_grad(loss_fn, state["params"],
                                          state["frozen"], _batch(b, prog),
                                          0)
        out.append({p: g for p, g in zip(paths, _vit_gathered(
            grads, state["params"])) if "tokenizers" in p
            and not p.endswith("text/embed")})
    return out


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def vit_post(cfg_kw, case, n_classes, params_np, frozen_np, batch_np):
    """The post-training model under the active program: the tokenizers
    FedAvg-ed over the global client axis (whole on every rank: their
    leaves, the text table cut, and a digest of every bit; and weighted
    by the batch's mask entries), the body
    assembled from this rank's shards (each frozen shard's spec kept
    through its cast, where a plain ``Tensor.to`` drops it), evaluated on
    the batch with its samples on the client axis: the logits, or the
    retrieval embeddings and recall at 1 and 5 over the global batch,
    gathered."""
    cfg = _config(cfg_kw)
    prog = C.active()
    task, fusion, mods = VIT_CASES[case]
    run = _vit_run(cfg, batch_np["mask"].shape[0], fusion, False)
    state = _vit_state(params_np, frozen_np)
    params, frozen = state["params"], state["frozen"]
    plan = split.make_split_plan(cfg, run.mpsl)
    axis = C.client_axis()
    batch = _batch(batch_np, prog)
    with torch.no_grad():
        C.reset_counts()
        heads = aggregation.fedavg_heads(params["client"]["tokenizers"])
        fedavg_counts = C.read_counts()
        weighted = aggregation.fedavg_heads(params["client"]["tokenizers"],
                                            weights=batch["mask"])
        full = split.assemble_full_params(params, frozen, plan)
        shards = (tree.leaves(frozen["segments"])
                  + tree.leaves(params["server"]["segments"]))
        body = tree.leaves(full["segments"])
        cast = frozen["segments"][0][0]["attn"]["wq"]
        full["tokenizers"] = heads
        full.update({k: v for k, v in params["server"].items()
                     if k not in ("segments", "final_norm")})
        x = {m: batch[m].flatten(0, 1) for m in mods}
        def cut(t):
            return [_np(h[:TEXT_ROWS]) if p.endswith("text/embed")
                    else _np(h) for p, h in zip(tree.paths(t),
                                                tree.leaves(t))]

        out = {"heads": cut(heads), "weighted": cut(weighted),
               "heads_digest": _digest(_np(h) for h in tree.leaves(heads)),
               "fedavg_counts": fedavg_counts,
               "body_specs_kept": len(body) == len(shards) and all(
                   C.spec_of(a) == C.spec_of(b) and a.dtype == torch.float32
                   for a, b in zip(body, shards)),
               "frozen_spec": C.spec_of(cast),
               "plain_cast_spec": C.spec_of(cast.to(torch.float32))}
        if task == "retrieval":
            pa, pb = baselines.retrieval_embeddings(full, x, cfg, mods)
            pa, pb = (C.all_gather(t, 0, axis) for t in (pa, pb))
            out.update(pa=_np(pa), pb=_np(pb),
                       recall_at_1=float(losses.recall_at_k(pa, pb, 1)),
                       recall_at_5=float(losses.recall_at_k(pa, pb, 5)))
        else:
            logits = baselines.full_vit_logits(full, x, cfg, modalities=mods,
                                               fusion_mode=fusion)
            out["logits"] = _np(C.all_gather(logits, 0, axis))
    return out


def vit_cases(worlds):
    """Each (label, mesh, steps, props, posts) of `worlds` under a program
    on its mesh, in order: {label: {"steps": [vit_step(*a)], "props":
    [vit_tokenizer_grads(*a)], "posts": [vit_post(*a)]}}."""
    out = {}
    dev = C.active().device
    for label, m, steps_, props, posts in worlds:
        with C.program(mesh_lib.init_device_mesh(m, dev)):
            out[label] = {"steps": [vit_step(*a) for a in steps_],
                          "props": [vit_tokenizer_grads(*a) for a in props],
                          "posts": [vit_post(*a) for a in posts]}
    return out
