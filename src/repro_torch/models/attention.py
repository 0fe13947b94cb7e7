"""Self-attention: GQA with RoPE, optional qkv bias and qk-norm, causal /
full / sliding-window masks by absolute positions, and a KV cache.

Interchangeable implementations of the core softmax(QK^T)V:
  * naive     — materializes scores; the oracle and the plain path.
  * blockwise — an online-softmax loop over KV blocks of ``block`` keys,
                each step under ``torch.utils.checkpoint`` (its scores
                are recomputed in the backward, never stashed): memory
                O(Sq * block). The plain path at long sequences.
  * auto      — the JAX package's rule: blockwise where Sk > 2048 and
                Sq > 1, else naive.
  * kernel    — ``kernels.ops.flash_attention``: the hand-written CUDA
                kernel on a CUDA tensor, its plain version on a CPU
                tensor. Like the JAX package's ``pallas``, it serves
                prefill AND decode.
A decode step (Sq 1) asked for blockwise takes naive, as in the JAX
package: its scores are [B, H, 1, Sk].

Positions are [B, S], or [B, 3, S] under M-RoPE (Qwen2-VL), whose row 0
is the flat position the masks, the kernel and the KV cache use.
Cross-attention (the whisper decoder) takes its keys and values from the
encoder's output (``kv_x``) or, at decode, precomputed once per layer
(``compute_cross_kv``); it rotates neither queries nor keys.

Under the SPMD program (``parallel.collectives``) the weights lie as the
rule table lays them (``model_layout``):

  * heads: H and K divide the model axis: wq [D, H, hd] and wk / wv
    [D, K, hd] hold H/m and K/m heads (G unchanged, so the core runs as
    it is, the flash kernel included, at the local head counts), wo
    [H, hd, D] is row-parallel and its partial sums leave by one
    all-reduce over `model`; the KV cache holds this rank's K/m heads.
  * dboth: neither count divides it (hymba-1.5b's 25 on 5): every
    weight's D lies on (data, model) (``model`` alone in the serving
    layout). x's columns that a rank's rows of wq / wk / wv hold
    (``collectives.model_cols``) contract them, and the three partial
    products leave by one all-reduce: every model rank then holds every
    head and runs the whole core, whose output enters wo's columns by
    ``copy_to``; wo's output D is this rank's part, joined over `model`
    by ``collectives.join_model_parts``. The KV cache holds every head,
    and where its length divides the model axis 1/m of its slots (the
    rule table's sequence-sharded cache): prefill writes only this rank's
    slots, decode writes the new entry on the rank that owns its slot and
    each rank attends over its own slots, the partials merged by lse
    across `model` (``_merged_attention``).
  * mixed: H divides the model axis and K does not (reduced hymba-1.5b's
    4 on 1): the query heads as under heads, wk / wv as under dboth
    (whole KV heads on every rank, entering the rank's query heads by
    ``copy_to``, each query head reading its own KV head), the cache as
    under dboth; a decode step over a sequence-sharded cache all-gathers
    the query heads first.

Cross-attention (the whisper decoder) under heads projects x and
``kv_x`` through this rank's heads; under dboth q comes from x and k, v
from ``kv_x`` through two row-parallel products (``_row_parallel``), one
all-reduce each, ``kv_x`` having entered the region by ``copy_to`` (so
the encoder output's gradient is the sum of the ranks' parts). The cross
K/V kept for decode (``compute_cross_kv``) hold every KV head on every
model rank, the batch on `data` (``steps.cross_kv_specs``): under dboth
the row-parallel products give them, under heads this rank's heads are
all-gathered over `model`, and a decode step's cross-attention reads
its query heads' KV heads (``_for_heads``).

Each weight's fsdp dim is gathered at use. Under ``seq_model`` the
block boundary cuts the stream (``models.model.cut_stream``): attention
runs on the whole sequence, gathered at the block's entry. Under
``RunConfig.attn_seq_shard`` (``seq_shard``) a self-attention of Sq > 1
queries that divide the model axis runs its core over this model rank's
contiguous S/m queries, every head, against the whole K / V
(``_query_slice``, ``_query_joined``: the autograd pairs only; where the
JAX partitioner would move heads to the sequence by an all-to-all, the
pairs all-gather, more bytes for the same data); decode, the merged
split-KV decode and cross-attention are unchanged. Cross-attention under
mixed is not in the program (ROADMAP.md Queue 1 item 7: no config
reaches it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.parallel import collectives as C

NEG_INF = -0.7 * torch.finfo(torch.float32).max


# ---------------------------------------------------------------------------
# Params


def init_attention(generator, cfg, device=None):
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": layers.dense_init(generator, (d, h, hd), in_axis_size=d,
                                device=device),
        "wk": layers.dense_init(generator, (d, k, hd), in_axis_size=d,
                                device=device),
        "wv": layers.dense_init(generator, (d, k, hd), in_axis_size=d,
                                device=device),
        "wo": layers.dense_init(generator, (h, hd, d), in_axis_size=h * hd,
                                device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), device=device)
        p["bk"] = torch.zeros((k, hd), device=device)
        p["bv"] = torch.zeros((k, hd), device=device)
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.zeros((hd,), device=device)}
        p["k_norm"] = {"scale": torch.zeros((hd,), device=device)}
    return p


def _proj(x, w):
    """x [B,S,D] . w [D,N,hd] -> [B,S,N,hd], contiguous."""
    y = x @ w.reshape(w.shape[0], -1).to(x.dtype)
    return y.view(*x.shape[:-1], *w.shape[1:])


# ---------------------------------------------------------------------------
# Masks


def _mask_bias(q_pos, k_pos, causal: bool, window: int, k_valid=None):
    """Additive bias [B, Sq, Sk] from absolute positions.

    q_pos [B, Sq], k_pos [B, Sk]; window > 0 keeps keys with
    q_pos - k_pos < window. k_valid optionally marks populated KV slots."""
    ok = torch.ones((q_pos.shape[0], q_pos.shape[1], k_pos.shape[1]),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[:, None, :] <= q_pos[:, :, None]
    if window and window > 0:
        ok &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    if k_valid is not None:
        ok &= k_valid[:, None, :]
    return torch.where(ok, 0.0, NEG_INF).float()


# ---------------------------------------------------------------------------
# Core implementations


def _naive_attention(q, k, v, bias):
    """q [B,Sq,H,hd], k/v [B,Sk,K,hd], bias [B,Sq,Sk] -> [B,Sq,H,hd]."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    s = s * (hd ** -0.5) + bias[:, None, None, :, :]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return o.reshape(b, sq, h, hd)


def _block_step(qg, kc, vc, q_pos, pc, vm, acc, m, l, causal, window):
    """One KV block of the online softmax: scores and the PV product in
    f32 from the operands' values (the JAX package's
    ``preferred_element_type=f32``; qg comes upcast), p cast to V's dtype
    before its product."""
    s = torch.einsum("bqkgd,bskd->bqkgs", qg, kc.float())
    s = s + _mask_bias(q_pos, pc, causal, window, vm)[:, :, None, None, :]
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bqkgs,bskd->bqkgd", p.to(vc.dtype).float(), vc.float())
    return acc, m_new, l


def _blockwise_attention(q, k, v, q_pos, k_pos, causal, window,
                         k_valid=None, block: int = 1024):
    """Online-softmax loop over KV blocks. Memory O(Sq * block).

    Sk is padded to whole blocks with keys at position -1 that are not
    valid. Each block step runs under ``torch.utils.checkpoint``, as the
    JAX package's runs under ``jax.checkpoint(nothing_saveable)``: the
    backward keeps each step's inputs (the running acc, m, l) and
    recomputes its [Sq, block] scores, which are never stashed."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    sk = k.shape[1]
    nb = -(-sk // block)
    pad = nb * block - sk
    valid = (k_valid if k_valid is not None
             else torch.ones((b, sk), dtype=torch.bool, device=q.device))
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1)
        valid = F.pad(valid, (0, pad), value=False)
    # the scaled q in q's dtype, as the JAX package rounds it, upcast once
    qg = (q * hd ** -0.5).reshape(b, sq, kh, g, hd).float()
    acc = torch.zeros((b, sq, kh, g, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, sq, kh, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, sq, kh, g), dtype=torch.float32, device=q.device)
    for i in range(nb):
        blk = slice(i * block, (i + 1) * block)
        args = (qg, k[:, blk], v[:, blk], q_pos, k_pos[:, blk], valid[:, blk],
                acc, m, l, causal, window)
        if torch.is_grad_enabled():
            acc, m, l = torch.utils.checkpoint.checkpoint(
                _block_step, *args, use_reentrant=False,
                preserve_rng_state=False)
        else:
            acc, m, l = _block_step(*args)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def resolve_impl(impl: str, sq: int, sk: int) -> str:
    """The impl a call runs: ``auto`` by the JAX package's rule (blockwise
    where Sk > 2048 and Sq > 1, else naive), and a decode step (Sq 1)
    asked for blockwise takes naive."""
    if impl == "auto" or (sq == 1 and impl == "blockwise"):
        return "blockwise" if sk > 2048 and sq > 1 else "naive"
    return impl


# ---------------------------------------------------------------------------
# Cache


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device=None):
    """KV cache of one layer; `index` counts the entries written so far
    (the global count, the same on every rank). Under the SPMD program it
    holds this rank's part of the rule table's layout
    (``sharding.cache_dims``), and its tensors carry that spec: its batch
    rows (`batch` is the local batch), its K/m heads where the KV heads
    divide the model axis, else, where `cache_len` divides it, every head
    over 1/m of the slots (global slots r L/m .. (r+1) L/m on model rank
    r: ``cache_slots``)."""
    kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    m = C.size("model")
    heads_on = m > 1 and kh % m == 0
    seq_on = m > 1 and not heads_on and cache_len % m == 0
    kh = kh // m if heads_on else kh
    slots = cache_len // m if seq_on else cache_len
    cache = {
        "k": torch.zeros((batch, slots, kh, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, slots, kh, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, slots), -1, dtype=torch.int32,
                          device=device),
        "index": 0,
    }
    if C.active() is not None:
        rows = C.client_entry()
        seq = "model" if seq_on else None
        C.set_spec(cache["k"], (rows, seq, "model" if heads_on else None,
                                None))
        C.set_spec(cache["v"], C.spec_of(cache["k"]))
        C.set_spec(cache["pos"], (rows, seq))
    return cache


def cache_slots(cache):
    """(this rank's first slot, the cache's slot count) of a KV cache, by
    the global slot numbers: (0, its length) unless its slots lie on
    `model` (a sequence-sharded cache)."""
    n = cache["k"].shape[1]
    m = C.size("model")
    if m > 1 and "model" in C.dim_axes(cache["k"], 1):
        return C.index("model") * n, n * m
    return 0, n


def _cache_insert(cache, k_new, v_new, positions):
    """Insert Sq new KV entries, updating the cache IN PLACE (the JAX
    package builds a new cache instead; the buffers are the same).

    Ring-buffered for window caches: the write offset is index % cache_len.
    Decode writes Sq == 1 (never straddles); prefill (Sq > 1) starts at
    index 0 — when the new sequence exceeds a window cache, only the last
    cache_len entries are kept, rotated so that the oldest lies at slot
    Sq % cache_len, where the next decode step writes. (The JAX package
    writes them unrotated: after a prefill of 1536 into a 1024-slot
    window, its first decode step overwrites the entry of position 1024,
    inside the window, and keeps 512, outside it. ROADMAP.md Queue 3.)

    Slots are global (``cache_slots``): a rank holding a sequence-shard
    writes only the entries whose slots it owns, and the ring wraps at
    the global length."""
    off, cache_len = cache_slots(cache)
    held = cache["k"].shape[1]
    sq = k_new.shape[1]
    if sq >= cache_len and sq > 1:            # prefill into a window cache
        shift = sq % cache_len
        k_new, v_new, positions = (
            torch.roll(t[:, -cache_len:], shift, dims=1)
            for t in (k_new, v_new, positions))
        idx = 0
    else:
        idx = cache["index"] % cache_len
    n = k_new.shape[1]
    idx = min(idx, cache_len - n)     # a dynamic_update_slice clamps likewise
    lo, hi = max(idx, off), min(idx + n, off + held)
    if lo < hi:
        new = slice(lo - idx, hi - idx)
        cache["k"][:, lo - off:hi - off] = k_new[:, new]
        cache["v"][:, lo - off:hi - off] = v_new[:, new]
        cache["pos"][:, lo - off:hi - off] = positions[:, new]
    cache["index"] += sq
    return cache


# ---------------------------------------------------------------------------
# Public entry


def _norm_scale(params, name, tp):
    """A qk-norm scale [hd]: replicated, used by this rank's heads only, so
    its gradient is summed over `model` (``copy_to``)."""
    scale = params[name]["scale"]
    return C.copy_to(scale, "model") if tp else scale


def model_layout(params) -> str:
    """Where the attention weights lie under the SPMD program: "heads"
    (the query and KV heads on `model`), "mixed" (the query heads on
    `model`, the KV heads' wk / wv on D: a KV head count that does not
    divide the axis beside a query head count that does), "dboth" (every
    weight's D on `model`, with or without `data`: neither count divides
    it) or "replicated" (nothing on `model`)."""
    wq, wk = params["wq"], params["wk"]
    if not (C.model_parallel(wq) or C.model_parallel(wk)):
        return "replicated"
    q_heads = "model" in C.dim_axes(wq, 1)
    kv_heads = "model" in C.dim_axes(wk, 1)
    kv_rows = "model" in C.dim_axes(wk, 0)
    if q_heads and kv_heads:
        return "heads"
    if q_heads and kv_rows:
        return "mixed"
    if kv_rows and "model" in C.dim_axes(wq, 0):
        return "dboth"
    raise NotImplementedError(
        f"attention weights laid out wq {C.spec_of(wq)}, wk "
        f"{C.spec_of(wk)}: ROADMAP.md Queue 1 item 7")


def _row_parallel(params, names, x):
    """The projections [B, S, N, hd] of x by the weights `names`, each
    with its D on `model` (the dboth layout), whole heads on every model
    rank: this rank's columns of x contract its rows of each weight (their
    D's data part gathered), and the partial products leave by one
    all-reduce over `model`."""
    ws = [C.gather_param(params[n]) for n in names]
    xl = C.model_cols(x, C.spec_of(params[names[0]])[0])
    flat = torch.cat([w.reshape(w.shape[0], -1) for w in ws], dim=1)
    y = C.reduce_from(xl @ flat.to(x.dtype), "model")
    return [t.reshape(*x.shape[:-1], *w.shape[1:]) for t, w in zip(
        y.split([w.shape[1] * w.shape[2] for w in ws], dim=-1), ws)]


def _for_heads(t, hq):
    """The KV heads [B, S, ., hd] that this model rank's hq query heads
    (r hq .. (r+1) hq of H = m hq) read, from every KV head `t`: a slice
    where each of its KV heads' query groups lies whole on the rank (G
    kept), else one KV head a query head (G 1)."""
    g = hq * C.size("model") // t.shape[2]
    first = C.index("model") * hq
    if hq % g == 0:
        return t[:, :, first // g:(first + hq) // g]
    idx = torch.arange(first, first + hq, device=t.device) // g
    return t.index_select(2, idx)


def _merged_attention(q, k, v, q_pos, k_pos, causal, window, k_valid, impl):
    """Attention of q (every head) over a sequence-sharded KV cache: each
    model rank attends over its own slots (the flash kernel's split route
    where impl is "kernel", its plain version otherwise), returning o and
    lse; a row with no valid key among them (o = 0, lse = 0 from the
    kernel) is marked lse = -inf, so that it weighs nothing; the ranks'
    o (in f32) and lse are all-gathered over `model` in one tensor and
    merged by lse (``flash_attention.merge_partials``, the split route's
    combine). Inference only: no gradient flows through it."""
    if impl == "kernel":
        o, lse = kops.flash_attention_partial(q, k, v, q_pos, k_pos, causal,
                                              window, k_valid)
    else:
        o, lse = _fa.flash_attention_plain(q, k, v, q_pos, k_pos,
                                           causal=causal, window=window,
                                           k_valid=k_valid)
    seen = _fa.pair_mask(q_pos, k_pos, k_valid, causal, int(window)).any(-1)
    lse = torch.where(seen[:, None, :], lse, float("-inf"))
    b, sq, h, hd = o.shape
    packed = torch.cat([o.float().reshape(b, sq, h * hd),
                        lse.transpose(1, 2)], dim=-1)
    parts = C.all_gather(packed[None], 0, "model")
    o_parts = parts[..., :h * hd].reshape(-1, b, sq, h, hd)
    lse_parts = parts[..., h * hd:].transpose(2, 3)
    return _fa.merge_partials(o_parts, lse_parts, q.dtype)[0]


def _query_slice(q, k, v, q_pos, layout):
    """This model rank's contiguous S/m slice of the queries (and of their
    positions), every head, against the whole K / V of every head (the JAX
    ``attn_seq_shard`` layout: q on ("batch", "seq_model"), K / V whole).
    heads and mixed first gather the query heads over `model`, heads the
    KV heads too (``gather_to``: each rank's gradient is its heads'
    slice); K / V enter by ``copy_to`` (each rank's dk / dv is a partial
    sum over its queries), but under mixed, where they are whole and
    entered already; q leaves by ``slice_to`` (its gradient's parts
    all-gathered)."""
    if layout in ("heads", "mixed"):
        q = C.gather_to(q, 2, "model")
    if layout == "heads":
        k, v = C.gather_to(k, 2, "model"), C.gather_to(v, 2, "model")
    if layout != "mixed":
        k, v = C.copy_to(k, "model"), C.copy_to(v, "model")
    part = q_pos.chunk(C.size("model"), 1)[C.index("model")]
    return C.slice_to(q, 1, "model"), k, v, part


def _query_joined(out, layout):
    """The core's output of ``_query_slice``'s queries joined whole over
    `model` (``gather_to``: each rank's gradient is its queries' slice),
    then, under heads and mixed, this rank's heads again (``slice_to``)
    for wo's row-parallel product."""
    out = C.gather_to(out, 1, "model")
    if layout in ("heads", "mixed"):
        out = C.slice_to(out, 2, "model")
    return out


def _core(q, k, v, q_pos, k_pos, causal, window, k_valid, impl, block):
    if impl == "naive":
        bias = _mask_bias(q_pos, k_pos, causal, window, k_valid)
        return _naive_attention(q, k, v, bias)
    if impl == "blockwise":
        return _blockwise_attention(q, k, v, q_pos, k_pos, causal, window,
                                    k_valid, block=block)
    if impl == "kernel":
        return kops.flash_attention(q, k, v, q_pos, k_pos, causal=causal,
                                    window=window, k_valid=k_valid)
    raise ValueError(f"unknown attention impl {impl!r} "
                     f"(naive | blockwise | auto | kernel)")


def apply_attention(params, x, cfg, *, positions, causal=True, window=0,
                    cache=None, impl="naive", block=1024, kv_x=None,
                    precomputed_kv=None, x_entered=False, seq_shard=False):
    """x [B, S, D] -> (out [B, S, D], cache).

    positions: [B, S] int32 absolute positions, or [B, 3, S] for M-RoPE.
    cache: None for train/prefill-without-cache, else a KV cache dict,
      which is updated in place and returned.
    kv_x: cross-attention source [B, Sk, D] (keys and values from the
      encoder, at positions 0..Sk-1).
    precomputed_kv: {"k", "v", "pos"} of ``compute_cross_kv``: decode-time
      cross-attention, every key valid.
    impl: naive | blockwise | auto | kernel; block: blockwise's KV block.
    x_entered: x has entered the model-parallel region already (the
      hybrid block's ``copy_to``, shared by both branches).
    seq_shard: ``RunConfig.attn_seq_shard``: under the SPMD program, a
      self-attention of Sq > 1 queries (training, prefill) whose Sq
      divides the model axis runs its core over this model rank's S/m
      queries against the whole K / V (``_query_slice``); elsewhere, and
      with no program, the flag changes nothing.
    Self-attention rotates q and k by the config's rope / mrope;
    attention over outside keys (``kv_x`` or ``precomputed_kv``) rotates
    neither."""
    hd = cfg.resolved_head_dim
    flat_pos = positions[:, 0] if positions.dim() == 3 else positions
    layout = model_layout(params)
    q_tp = layout in ("heads", "mixed")       # this rank's query heads
    cross = kv_x is not None or precomputed_kv is not None
    if layout == "mixed" and cross:
        raise NotImplementedError(
            "cross-attention under the mixed layout: ROADMAP.md Queue 1 "
            "item 7")
    if layout != "replicated" and not x_entered:
        x = C.copy_to(x, "model")
        if kv_x is not None:
            kv_x = C.copy_to(kv_x, "model")
    k = v = None
    if layout == "dboth" and not cross:
        q, k, v = _row_parallel(params, ("wq", "wk", "wv"), x)
    elif layout == "dboth":
        # two row-parallel products, one all-reduce each: q of x, k and v
        # of the encoder output (at decode, kept by compute_cross_kv)
        q, = _row_parallel(params, ("wq",), x)
        if kv_x is not None:
            k, v = _row_parallel(params, ("wk", "wv"), kv_x.to(x.dtype))
    else:
        q = _proj(x, C.gather_param(params["wq"]))
        if layout == "mixed":
            k, v = _row_parallel(params, ("wk", "wv"), x)
        elif precomputed_kv is None:
            src = x if kv_x is None else kv_x.to(x.dtype)
            k = _proj(src, C.gather_param(params["wk"]))
            v = _proj(src, C.gather_param(params["wv"]))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        if k is not None:
            k = k + params["bk"].to(x.dtype)
            v = v + params["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = layers.rms_norm(q, _norm_scale(params, "q_norm", q_tp))
        if k is not None:
            k = layers.rms_norm(k, _norm_scale(params, "k_norm",
                                               layout == "heads"))
    if layout == "mixed":
        # whole KV heads, read by this rank's query heads only: their
        # gradients are the sum of the ranks' parts
        k, v = C.copy_to(k, "model"), C.copy_to(v, "model")

    if not cross and cfg.pos_embed in ("rope", "mrope"):
        if cfg.pos_embed == "mrope":
            pos3 = positions if positions.dim() == 3 else \
                positions[:, None, :].expand(-1, 3, -1)
            cos, sin = layers.mrope_cos_sin(pos3, hd, cfg.rope_theta,
                                            cfg.mrope_sections)
        else:
            cos, sin = layers.rope_cos_sin(flat_pos, hd, cfg.rope_theta)
        q = layers.apply_rope(q, cos, sin)
        k = layers.apply_rope(k, cos, sin)

    out = None
    if precomputed_kv is not None:
        # every KV head (compute_cross_kv): this rank's query heads' own
        k_all, v_all = (precomputed_kv[n].to(x.dtype) for n in ("k", "v"))
        if q_tp:
            k_all, v_all = (_for_heads(t, q.shape[2]) for t in (k_all, v_all))
        k_pos, k_valid = precomputed_kv["pos"], None
    elif cache is not None and q.shape[1] > 1:
        # PREFILL: attend over the full fresh sequence (an empty/stale ring
        # cache cannot serve early queries' windows), then write the cache.
        cache = _cache_insert(cache, k, v, flat_pos)
        k_all, v_all, k_pos, k_valid = k, v, flat_pos, None
    elif cache is not None:
        # DECODE: attend over the whole cache, empty slots masked out.
        cache = _cache_insert(cache, k, v, flat_pos)
        k_all, v_all = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
        k_pos, k_valid = cache["pos"], cache["pos"] >= 0
        if cache_slots(cache)[1] != k_all.shape[1]:
            # every head over this rank's slots, merged over the ranks
            q_all = C.all_gather(q, 2, "model") if q_tp else q
            out = _merged_attention(q_all, k_all, v_all, flat_pos, k_pos,
                                    causal, window, k_valid, impl)
            if q_tp:
                out = out.chunk(C.size("model"), 2)[C.index("model")]
    elif kv_x is not None:
        k_all, v_all, k_valid = k, v, None
        k_pos = layers.positions_from_shape(kv_x.shape[0], kv_x.shape[1],
                                            device=x.device)
    else:
        k_all, v_all, k_pos, k_valid = k, v, flat_pos, None

    m = C.size("model")
    sliced = (seq_shard and not cross and m > 1 and out is None
              and q.shape[1] > 1 and q.shape[1] % m == 0)
    if out is None:
        q_pos = flat_pos
        if sliced:
            q, k_all, v_all, q_pos = _query_slice(q, k_all, v_all, flat_pos,
                                                  layout)
        elif layout == "mixed":
            k_all, v_all = (_for_heads(t, q.shape[2]) for t in (k_all, v_all))
        out = _core(q, k_all, v_all, q_pos, k_pos, causal, window,
                    k_valid, resolve_impl(impl, q.shape[1], k_all.shape[1]),
                    block)
        if sliced:
            out = _query_joined(out, layout)

    b, s, h, _ = out.shape
    if layout == "dboth":
        # every rank's wo columns read the whole out: its gradient is the
        # sum of their parts
        out = C.copy_to(out, "model")
    wo = C.gather_param(params["wo"])
    y = out.reshape(b, s, h * hd) @ wo.reshape(h * hd, -1).to(x.dtype)
    if q_tp:
        y = C.reduce_from(y, "model")
    elif layout == "dboth":
        y = C.join_model_parts(y, C.spec_of(params["wo"])[2])
    return y, cache


def compute_cross_kv(params, enc_out, cfg):
    """Cross-attention K/V of the encoder output [B, Sk, D], computed once
    for every decode step: {"k", "v" [B, Sk, K, hd], "pos" [B, Sk]
    (0..Sk-1)}. Under the SPMD program every model rank holds every KV
    head and its own batch rows, the spec ``steps.cross_kv_specs`` gives
    them (the JAX ``cross_kv_shardings``): under dboth from the
    row-parallel products, under heads this rank's heads all-gathered
    over `model` in one collective. Inference only."""
    layout = model_layout(params)
    if layout == "mixed":
        raise NotImplementedError(
            "cross-attention under the mixed layout: ROADMAP.md Queue 1 "
            "item 7")
    if layout == "dboth":
        k, v = _row_parallel(params, ("wk", "wv"), enc_out)
    else:
        k = _proj(enc_out, C.gather_param(params["wk"]))
        v = _proj(enc_out, C.gather_param(params["wv"]))
    if cfg.qkv_bias:
        k = k + params["bk"].to(enc_out.dtype)
        v = v + params["bv"].to(enc_out.dtype)
    if cfg.qk_norm:
        k = layers.rms_norm(k, params["k_norm"]["scale"])
    if layout == "heads":
        k, v = C.all_gather(torch.stack([k, v]), 3, "model").unbind(0)
    pos = layers.positions_from_shape(enc_out.shape[0], enc_out.shape[1],
                                      device=enc_out.device)
    out = {"k": k, "v": v, "pos": pos}
    if C.active() is not None:
        rows = C.client_entry()
        for name, t in out.items():
            C.set_spec(t, (rows,) + (None,) * (t.dim() - 1))
    return out
