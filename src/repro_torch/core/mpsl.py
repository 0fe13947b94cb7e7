"""MPSL train step — the paper's technique, for the LM family and the
paper's own Meta-Transformer (ViT) setup.

Counterpart of the JAX package's ``core/mpsl.py`` (``make_lm_loss``,
``make_vit_loss``, ``make_train_step``). One step realizes the
client/server exchange:

  1. client forward  — per-client adapters (stacked [N, ...] params) on a
     frozen embedding make the smashed data a_n;
  2. uplink          — the clients' activations become the server's global
     batch (int8-compressed when enabled);
  3. server forward  — ONE pass over the concatenated global batch (frozen
     prefix + trainable suffix);
  4. tail + losses   — back in client layout, each client's loss against
     its own labels; L_S = sum_n w_n L_n with w_n = |B_n|/|B| over the
     participating clients;
  5. single backward — the gradient of L_S IS the paper's one aggregated
     backward pass; cut-layer gradients reach each client's adapter
     through it (int8-compressed when enabled).

``backward_mode='per_client'`` is the vanilla-PSL baseline: N backward
passes, one per client, summed with the same weights (under the SPMD
program every rank runs all N, ``_per_client_grads``).

Randomness. JAX threads a key; here a step's ``rng`` is an int derived
from the state's seed and the step, and the loss draws the links'
stochastic rounding from generators seeded by it, so the same rng gives
the same draws (as the same key does). A test may pass instead a dict
``{"uplink": u, "downlink": u}`` of uniforms to use as given; the ViT
loss, whose late-fusion and retrieval paths send one link a modality,
takes one such dict a link name (``{"joint": {...}}`` under early
fusion, else ``{"vision": {...}, "text": {...}, ...}``).

Under the SPMD program (``parallel.collectives``) the clients lie on the
client axis (``collectives.client_axis``: `data`, or (pod, data) on a
multi-pod mesh): each of its ranks runs its N/d clients (their tokens,
labels, mask entries and adapters, ``place_state`` / ``place_batch``)
through the server's shards. The client weights read the global mask
(its sum all-reduced over the client axis); each rank's links quantise
its clients' rows with the draws the whole stacked tensor's call gives
them (the global client offset, ``row0``); L_S is the sum over the
client ranks of their weighted client losses, plus the router's aux loss
taken over every client's tokens (``models/moe.py``), as the reference
couples them. A rank backpropagates its own part; the step sums the
server leaves' gradients over the client axis
(``collectives.reduce_grads``: an fsdp leaf's was reduce-scattered over
`data` by its gather and crosses `pod` alone, an adapter holds only this
rank's clients), and the global norm counts each shard once.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.configs import port_impls
from repro_torch.core import compression, fusion, losses, split
from repro_torch.models import layers, model as M, tokenizers as tok
from repro_torch.obs import comm as obs_comm
from repro_torch.optim import (adamw_init, adamw_update, apply_updates,
                               clip_by_global_norm)
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding

# the kernels and the ragged dispatch, by name: what the entry points
# (the train CLI, the Trainer's builds, chip_smoke.py) ask for
KERNEL_IMPLS = {"attn": "kernel", "ce": "kernel", "ssm": "kernel",
                "moe": "ragged"}


def run_impls(run, impls=None) -> dict:
    """The impls a loss runs: ``run.impls`` (RunConfig's impl fields, as
    the JAX package's losses read them), overridden by `impls`, with the
    JAX names translated (``configs.port_impls``)."""
    return port_impls({**run.impls, **(impls or {})})


# ---------------------------------------------------------------------------
# Shared pieces


def _client_weights(mask, n):
    """w_n = |B_n| / |B| over participating clients (uniform B_n here);
    under the SPMD program `mask` is this client rank's clients' entries
    and the participating count is the global one."""
    m = mask.float()
    return m / torch.clamp(C.all_reduce(m.sum(), C.client_axis()), min=1.0)


def _client_offset(n_local: int) -> int:
    """The global index of this rank's first client (0 off the program)."""
    return C.index(C.client_axis()) * n_local


def _global_metrics(l_local, aux, per_client, mask, device):
    """The step's metrics from this client rank's part: L_S (the ranks'
    weighted sums added, then aux), every client's loss, the
    participating count."""
    axis = C.client_axis()
    aux = aux.detach() if torch.is_tensor(aux) \
        else torch.zeros((), device=device)
    return {"loss": C.all_reduce(l_local.detach(), axis) + aux,
            "per_client": C.all_gather(per_client.detach(), 0, axis),
            "aux": aux,
            "participating": C.all_reduce(mask.sum(), axis)}


def _account_links(h, mpsl, suffix: str = ""):
    """Per-link byte accounting of the client/server exchange.

    ``h`` is the stacked [N, Bn, ...] smashed data at the cut layer — its
    shape/dtype IS the uplink payload, and (by the symmetry of the cut)
    the cut-layer-gradient downlink moves the same geometry. Reads the
    shape on the host: no launch, no sync (``obs.comm`` sends a record
    only when one is new or changed)."""
    wire = (compression.compressed_bytes(h.shape[1:])
            if mpsl.compress_uplink else None)
    obs_comm.record_link("uplink.activations" + suffix, h.shape, h.dtype,
                         direction="uplink",
                         compressed=mpsl.compress_uplink,
                         wire_bytes_per_client=wire)
    wire = (compression.compressed_bytes(h.shape[1:])
            if mpsl.compress_downlink else None)
    obs_comm.record_link("downlink.gradients" + suffix, h.shape, h.dtype,
                         direction="downlink",
                         compressed=mpsl.compress_downlink,
                         wire_bytes_per_client=wire)


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data): splitmix64 of their mix."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) % 2 ** 64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % 2 ** 64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % 2 ** 64
    return (z ^ (z >> 31)) >> 1


def _clients(u, c0: int, n: int):
    """Clients c0 .. c0 + n of given uniforms [N, ...] (all of them where
    n is None or N)."""
    return u if n is None or n == u.shape[0] else u[c0:c0 + n]


def _link_rng(rng, link: str, index: int, device, c0: int = 0,
              n: int = None):
    """A link's stochastic rounding: a generator seeded from the step's
    rng (the same on every rank), or the given uniforms [N, ...] of
    clients c0 .. c0 + n (this data rank's; all of them by default)."""
    if isinstance(rng, dict):
        return _clients(rng[link], c0, n)
    return torch.Generator(device=device).manual_seed(fold_in(rng, index))


def len_from_params(tree_) -> int:
    return sum(len(sp) for sp in tree_["segments"])


def _run_body(frozen, server, cfg, h, positions, impls, remat,
              enc_out=None):
    """Frozen prefix + trainable suffix, then final norm. Returns (h, the
    router's aux loss summed over both). Cross blocks attend over
    `enc_out`. Under seq_model (``impls["act_dims"]``) the stream is cut
    on the sequence over `model` before the first block and gathered
    whole before the final norm (``M.cut_stream``)."""
    fsegs, tsegs = split.split_segments(M.body_segments(cfg),
                                        len_from_params(frozen))
    aux = 0.0
    h, cut = M.cut_stream(h, impls)
    for sp, seg in ([*zip(frozen["segments"], fsegs)]
                    + [*zip(server["segments"], tsegs)]):
        h, _, a = M.apply_segment(sp, h, cfg, seg, positions=positions,
                                  enc_out=enc_out, impls=impls, remat=remat,
                                  seq_cut=cut)
        aux = aux + a
    return layers.apply_norm(M.whole_stream(h, cut), server["final_norm"],
                             cfg.norm), aux


# ---------------------------------------------------------------------------
# LM-family MPSL loss


def make_lm_loss(cfg, run, impls=None):
    """Returns loss_fn(trainable, frozen, batch, rng) -> (L_S, metrics).

    batch: tokens [N, Bn, S], labels [N, Bn, S] (int), mask [N] (f32);
    for the vlm family also patch_embeds [N, Bn, P, D], joined before the
    text (the loss is on the text region only, positions from
    ``layers.build_positions``); for audio frame_embeds [N, Bn, F, D], which each
    client's adapter maps before the frozen encoder runs over them, and
    whose encoding every decoder block cross-attends. As in the JAX
    package the frames cross the uplink uncompressed: only the text (and
    patch) activations take the links' quant8.
    impls: {"attn": "kernel" | "naive" | "blockwise" | "auto", "ce":
    "kernel" | "plain", "ssm": "kernel" | "plain", "ssm_chunk": int,
    "ssm_bwd": "fused" | "recompute", "moe": "ragged" | "dense" | "ep"};
    each key given overrides ``run.impls`` (``run_impls``: RunConfig's
    impl fields, the JAX names translated), as the JAX package's loss
    reads them. ``KERNEL_IMPLS`` asks for the kernels.

    L_S = sum_n w_n L_n + aux, the router's load-balance loss of the MoE
    blocks, as in the JAX package. aux is taken over every client's tokens
    and added after the client weights, so with ``router_aux_coef > 0`` a
    client with mask 0 still gets an adapter gradient, and one client's
    tokens move another's gradient through the expert density."""
    if cfg.family == "vit":
        raise ValueError("the vit family trains through make_vit_loss")
    if cfg.family not in M.LM_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    mpsl = run.mpsl
    cdt = getattr(torch, run.compute_dtype)
    impls = run_impls(run, impls)
    remat = run.remat != "none"

    def loss_fn(trainable, frozen, batch, rng):
        if cfg.encoder_layers and "frame_embeds" not in batch:
            raise ValueError(
                f"{cfg.name} needs frame_embeds: without them the JAX "
                f"package's cross blocks attend over the decoder's own "
                f"tokens, both ways (ROADMAP.md Queue 3)")
        tokens = batch["tokens"]
        n, bn, s_text = tokens.shape            # this client rank's clients
        dev = tokens.device
        c0 = _client_offset(n)
        adapter = trainable["client"]["adapter"]

        # ---- 1. client forward: frozen tokenizer + per-client adapter ----
        h = layers.embed_lookup(frozen["embed"]["table"], tokens).to(cdt)
        if cfg.pos_embed == "learned":
            h = h + layers.learned_positions(frozen["embed"]["pos"],
                                             s_text).to(cdt)
        patches = batch.get("patch_embeds")
        if patches is not None:
            h = torch.cat([patches.to(cdt), h], dim=2)
        h = split.apply_client_adapter(adapter, h)
        s = h.shape[2]

        # ---- 2. uplink (smashed data) ----
        _account_links(h, mpsl)
        row0 = c0 * bn * s                    # this rank's first token row
        if mpsl.compress_uplink:
            h = compression.compress_activations(
                h, _link_rng(rng, "uplink", 1, dev, c0, n), row0)
        if mpsl.compress_downlink:
            h = compression.compress_gradients(
                h, _link_rng(rng, "downlink", 2, dev, c0, n), row0)
        hb = h.reshape(n * bn, s, cfg.d_model)
        positions = layers.build_positions(
            cfg, n * bn, s, None if patches is None else patches.shape[2],
            dev)

        # ---- whisper: the frozen encoder over the clients' frames ----
        enc_out = None
        if "frame_embeds" in batch:
            fe = split.apply_client_adapter(
                adapter, batch["frame_embeds"].to(cdt))
            enc_out = M.run_encoder(
                frozen, fe.reshape(n * bn, fe.shape[2], cfg.d_model), cfg,
                impls=impls, remat=remat)

        # ---- 3. server forward: ONE pass over the global batch ----
        hb, aux = _run_body(frozen, trainable["server"], cfg, hb, positions,
                            impls, remat, enc_out)

        # ---- 4. tail in CLIENT layout: labels never leave their client ----
        # (the next-token loss on the text region only)
        hc = hb.reshape(n, bn, s, cfg.d_model)[:, :, s - s_text:]
        flat_h = hc[:, :, :-1, :].reshape(-1, cfg.d_model)
        flat_l = batch["labels"][:, :, 1:].reshape(-1)
        w_tail = (trainable["server"]["lm_head"]
                  if "lm_head" in trainable["server"]
                  else frozen["embed"]["table"].T)
        per_tok = losses.chunked_softmax_xent(flat_h, w_tail, flat_l,
                                              chunk=run.ce_chunk,
                                              impl=impls["ce"])
        per_client = per_tok.reshape(n, -1).mean(dim=1)        # L_n

        # ---- 5. aggregated loss => single backward pass ----
        w = _client_weights(batch["mask"], n)
        l_local = (w * per_client).sum()
        l_s = l_local + aux
        if C.size(C.client_axis()) > 1:
            # this rank's part of L_S (its clients, and aux once: its
            # gradient reaches this rank's tokens only); the metrics hold
            # the whole
            return l_s, _global_metrics(l_local, aux, per_client,
                                        batch["mask"], dev)
        metrics = {"loss": l_s.detach(), "per_client": per_client.detach(),
                   "aux": (aux.detach() if torch.is_tensor(aux)
                           else torch.zeros((), device=dev)),
                   "participating": batch["mask"].sum()}
        return l_s, metrics

    return loss_fn


# ---------------------------------------------------------------------------
# Paper-mode (ViT / Meta-Transformer) MPSL loss


def _vit_link_rng(rng, link: str, direction: str, device, c0: int = 0,
                  n: int = None):
    """A link's stochastic rounding. Every link draws from the same two
    streams, seeded from fold_in(rng, 2), as the JAX package's loss splits
    one (r_up, r_down) from fold_in(rng, 2) for all of them; a dict gives
    each link its own uniforms [N, ...], of which clients c0 .. c0 + n
    are this client rank's (all of them by default)."""
    if isinstance(rng, dict):
        return _clients(rng[link][direction], c0, n)
    seed = fold_in(fold_in(rng, 2), 1 if direction == "uplink" else 2)
    return torch.Generator(device=device).manual_seed(seed)


def make_vit_loss(cfg, run, modalities=("vision", "text"),
                  task: str = "classification", n_classes: int = 10,
                  impls=None):
    """Returns loss_fn(trainable, frozen, batch, rng) -> (L_S, metrics).

    batch: one raw input a modality ({vision: [N, Bn, 224, 224, 3], text:
    [N, Bn, 77] ids, audio: [N, Bn, 1024, 128]}), labels [N, Bn] (for
    classification) and mask [N]. Each client's tokenizers make its
    smashed data. Classification: under early fusion the modalities'
    tokens are joined client-side and cross one link ("joint") into one
    encoder pass; under late fusion each modality crosses its own link
    into its own pass, and the passes' summaries are joined after; the
    pooled embedding feeds the task head. Retrieval (task="retrieval"):
    one pass a modality, the two pooled embeddings projected (proj_a on
    the first modality in sorted order) into a symmetric InfoNCE at
    temperature 1 / exp(logit_scale). impls as for ``make_lm_loss``.

    Under the SPMD program each client rank runs its N/d clients (their
    tokenizers, inputs, labels and mask entries: ``place_state``,
    ``place_batch``) through the server's shards. Each link quantises
    this rank's rows with the draws the whole stacked call gives them
    (row0 = c0 Bn T, T the link's tokens); retrieval's InfoNCE runs over
    the global batch (``losses.contrastive_loss``); the loss is this
    rank's part of L_S, the metrics the whole, as in ``make_lm_loss``."""
    if task not in ("classification", "retrieval"):
        raise ValueError(f"unknown task {task!r}")
    mpsl = run.mpsl
    cdt = getattr(torch, run.compute_dtype)
    impls = run_impls(run, impls)
    remat = run.remat != "none"

    def encode(frozen, server, h):
        positions = layers.positions_from_shape(h.shape[0], h.shape[1],
                                                device=h.device)
        return _run_body(frozen, server, cfg, h, positions, impls, remat)

    def loss_fn(trainable, frozen, batch, rng):
        mask = batch["mask"]
        n = mask.shape[0]                       # this client rank's clients
        dev = mask.device
        c0 = _client_offset(n)
        server = trainable["server"]

        # ---- client tokenizers (each client its own params) ----
        tokenized = {m: tok.apply_stacked(
                         trainable["client"]["tokenizers"][m], batch[m],
                         tok.MODALITIES[m], cdt)
                     for m in modalities}
        bn = tokenized[modalities[0]].shape[1]

        def uplink(a, link):
            _account_links(a, mpsl, suffix="/" + link)
            row0 = c0 * bn * a.shape[2]       # this rank's first token row
            if mpsl.compress_uplink:
                a = compression.compress_activations(
                    a, _vit_link_rng(rng, link, "uplink", dev, c0, n), row0)
            if mpsl.compress_downlink:
                a = compression.compress_gradients(
                    a, _vit_link_rng(rng, link, "downlink", dev, c0, n),
                    row0)
            return a.reshape((n * bn,) + a.shape[2:])

        def encode_each():
            enc, aux = {}, 0.0
            for m in modalities:
                enc[m], a = encode(frozen, server, uplink(tokenized[m], m))
                aux = aux + a
            return enc, aux

        if task == "retrieval":
            enc, aux = encode_each()
            ma, mb = sorted(modalities)
            emb_a = fusion.gap(fusion.summarize_modality(ma, enc[ma]))
            emb_b = fusion.gap(fusion.summarize_modality(mb, enc[mb]))
            pa = emb_a @ server["proj_a"].to(cdt)
            pb = emb_b @ server["proj_b"].to(cdt)
            temp = 1.0 / torch.exp(server["logit_scale"])
            per_sample = losses.contrastive_loss(pa, pb, temp)   # [N*Bn]
        else:
            if mpsl.fusion == "early":
                joint = fusion.fuse_early(tokenized)             # [N,Bn,T,D]
                h, aux = encode(frozen, server, uplink(joint, "joint"))
                emb = fusion.gap(h)                              # [N*Bn, D]
            else:
                enc, aux = encode_each()
                emb = fusion.gap(fusion.fuse_late(enc))
            th = server["task_head"]
            logits = emb @ th["w"].to(cdt) + th["b"].to(cdt)
            per_sample = losses.softmax_xent(logits,
                                             batch["labels"].reshape(-1))
        per_client = per_sample.reshape(n, bn).mean(dim=1)       # L_n

        w = _client_weights(mask, n)
        l_local = (w * per_client).sum()
        l_s = l_local + aux
        if C.size(C.client_axis()) > 1:
            return l_s, _global_metrics(l_local, aux, per_client, mask, dev)
        metrics = {"loss": l_s.detach(), "per_client": per_client.detach(),
                   "aux": (aux.detach() if torch.is_tensor(aux)
                           else torch.zeros((), device=dev)),
                   "participating": mask.sum()}
        return l_s, metrics

    return loss_fn


# ---------------------------------------------------------------------------
# Train step


def grad(loss, leaves):
    """Gradients of `loss` w.r.t. `leaves`. A leaf with no path to the
    loss (a paper-mode client's text table, read detached) gets zeros, as
    JAX's stop_gradient gives it: AdamW's decoupled decay still moves that
    leaf, and the global norm counts it."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def value_and_grad(loss_fn, params, frozen, batch, rng):
    """(loss, metrics, gradients of the loss w.r.t. `params` leaves, in
    ``tree.leaves`` order, zeros for a leaf the loss does not reach); the
    params must require grad. Under the SPMD program the loss is the
    global L_S (``metrics["loss"]``) and the gradients this rank's part."""
    leaves = tree.leaves(params)
    loss, metrics = loss_fn(params, frozen, batch, rng)
    value = metrics["loss"] if C.size(C.client_axis()) > 1 \
        else loss.detach()
    return value, metrics, grad(loss, leaves)


def _split_microbatches(batch, mu: int):
    """[N, Bn, ...] client batches -> mu batches of [N, Bn/mu, ...]: each
    client's LOCAL minibatch is split (the client axis is kept)."""
    out = []
    for j in range(mu):
        mb = {}
        for k, x in batch.items():
            if k == "mask":
                mb[k] = x
                continue
            bn = x.shape[1]
            if bn % mu:
                raise ValueError(f"{k}: {bn} per client is not divisible "
                                 f"into {mu} microbatches")
            mb[k] = x[:, j * (bn // mu):(j + 1) * (bn // mu)]
        out.append(mb)
    return out


def _grad_agg(loss_fn, params, frozen, batch, rng, microbatches):
    if microbatches <= 1:
        return value_and_grad(loss_fn, params, frozen, batch, rng)
    g_acc, l_acc, mets = None, 0.0, []
    for mb in _split_microbatches(batch, microbatches):
        loss, met, g = value_and_grad(loss_fn, params, frozen, mb, rng)
        g_acc = list(g) if g_acc is None else [a + b for a, b in zip(g_acc, g)]
        l_acc = l_acc + loss
        mets.append(met)
        del g
    inv = 1.0 / microbatches
    metrics = {k: torch.stack([m[k] for m in mets]).mean(dim=0)
               for k in mets[0]}
    return l_acc * inv, metrics, [g * inv for g in g_acc]


def _per_client_grads(loss_fn, params, frozen, batch, rng):
    """Vanilla PSL: one backward per client, combined with the same global
    weights w_n the aggregated mode uses.

    Under the SPMD program every rank runs the passes of all N global
    clients, so that their collectives match across ranks: in pass i the
    client rank holding client i keeps that client's mask entry and zeros
    the rest (the JAX ``one(i)``: ``one_hot(i) * mask``), every other
    rank's entries are 0. w_i is the global weight, from the mask
    gathered over the client axis (one all-gather); each pass's loss is
    the global one (``value_and_grad``), and the summed gradients are this
    rank's part, which the step sums over the client axis
    (``reduce_grads``)."""
    mask = batch["mask"]
    n = mask.shape[0]                      # this client rank's clients
    c0 = _client_offset(n)
    mask_all = C.all_gather(mask, 0, C.client_axis())
    w = mask_all.float() / torch.clamp(mask_all.float().sum(), min=1.0)
    grads, ls = None, []
    for i in range(mask_all.shape[0]):
        m = torch.zeros_like(mask)
        if c0 <= i < c0 + n:
            m[i - c0] = mask[i - c0]
        l, _, g = value_and_grad(loss_fn, params, frozen,
                                  dict(batch, mask=m), rng)
        g = [x * w[i] for x in g]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        ls.append(l)
    ls = torch.stack(ls)
    loss = (w * ls).sum()
    return grads, loss, {"loss": loss, "per_client": ls,
                         "aux": torch.zeros((), device=loss.device),
                         "participating": mask_all.sum()}


def make_train_step(loss_fn, run, sched, backward_mode: str = "aggregated",
                    microbatches: int = 1, guard_nonfinite: bool = False,
                    grad_hook=None):
    """One MPSL optimization step (client + server updates):
    ``step(state, batch) -> (state, metrics)``, updating the state's params
    and AdamW moments in place.

    aggregated  — the paper's single backward pass over L_S.
    per_client  — vanilla-PSL baseline: N separate backward passes,
                  summed (same gradients by linearity, N times the cost).

    guard_nonfinite — when the aggregated loss or the grad norm is not
    finite, params and both Adam moments (and its count) keep every bit,
    decided on the device with no host readback; the step counter still
    advances and ``metrics["skipped"]`` carries the flag.

    grad_hook — called as grad_hook(step, grads) with the step's
    gradients (``tree.leaves`` order; summed over `data` under the SPMD
    program) before they are clipped; it must not modify them."""
    if backward_mode not in ("aggregated", "per_client"):
        raise ValueError(f"unknown backward mode {backward_mode!r}")

    def step(state, batch):
        rng = fold_in(state["rng"], state["step"])
        params = state["params"]
        if backward_mode == "aggregated":
            loss, metrics, grads = _grad_agg(loss_fn, params, state["frozen"],
                                             batch, rng, microbatches)
        else:
            grads, loss, metrics = _per_client_grads(
                loss_fn, params, state["frozen"], batch, rng)
        grads = list(grads)
        C.reduce_grads(tree.leaves(params), grads)
        if grad_hook is not None:
            grad_hook(state["step"], grads)
        grads, gnorm = clip_by_global_norm(grads, run.grad_clip,
                                           params=tree.leaves(params))
        lr = sched(state["step"])
        ok = None
        if guard_nonfinite:
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        updates = adamw_update(grads, state["opt"], tree.leaves(params),
                               lr=lr, weight_decay=run.weight_decay, ok=ok)
        apply_updates(tree.leaves(params), updates, ok=ok)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        if guard_nonfinite:
            okf = ok.float()
            metrics["skipped"] = 1.0 - okf
            p = metrics["participating"]
            metrics["participating"] = torch.where(torch.isfinite(p), p,
                                                   0.0) * okf
        state["step"] += 1
        return state, metrics

    return step


def undonated(step):
    """``step`` with the reference's undonated semantics: the step updates
    params and AdamW moments in place (the port's donation); this copy
    first clones both, so the caller's state stays valid and unchanged,
    at twice the param and optimizer memory (``--no-donate``)."""
    def clone(t):
        out = t.detach().clone().requires_grad_(t.requires_grad)
        C.set_spec(out, C.spec_of(t))
        return out

    def fresh_step(state, batch):
        return step(dict(state, params=tree.map_(clone, state["params"]),
                         opt=tree.map_(clone, state["opt"])), batch)

    return fresh_step


def state_shardings(state, mesh):
    """Specs mirroring a train state (the JAX ``state_shardings``):
    params, frozen and the AdamW moments by the rule table (the moments
    mirror their params: ZeRO-1), the count replicated, the host step and
    seed none."""
    opt = state["opt"]
    return {
        "params": sharding.param_specs(state["params"], mesh),
        "frozen": sharding.param_specs(state["frozen"], mesh),
        "opt": {"mu": sharding.param_specs(opt["mu"], mesh),
                "nu": sharding.param_specs(opt["nu"], mesh),
                "count": ()},
        "step": (), "rng": (),
    }


def place_state(state):
    """A whole train state (``init_state``'s, the same on every rank) as
    this rank's shards under the active SPMD program, the trainable
    shards made leaves that require grad; with no program, the state as
    it is (the JAX ``place_state``: the state committed to the mesh)."""
    prog = C.active()
    if prog is None:
        return state
    out = sharding.shard_tree(state, state_shardings(state, prog.mesh))
    for p in tree.leaves(out["params"]):
        p.requires_grad_(True)
    return out


def init_state(params, frozen, seed: int = 0):
    """The train state: trainable params (made leaves that require grad),
    the frozen tree, AdamW's moments, the step counter and the seed."""
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return {"params": params, "frozen": frozen, "opt": adamw_init(params),
            "step": 0, "rng": int(seed)}
