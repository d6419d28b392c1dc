"""Ring attention: context parallelism over the `sequence` mesh axis.

Counterpart of `llm_training_tpu/parallel/ring_attention.py`, with its
scheme. Each rank keeps its q chunk and the kv chunks travel round the
ring of sequence ranks; at chunk granularity causality makes the offset
static:

  kv chunk from an EARLIER position  -> full (unmasked) attention
  kv chunk from the SAME position    -> ordinary causal attention
  kv chunk from a LATER position     -> skipped entirely

Partial results merge by the running logsumexp (`_safe_weight`). The
backward re-runs the ring with the global LSE and delta, so each chunk
pair's dQ/dK/dV sum exactly to the whole sequence's gradient; the dK/dV
accumulators ride the ring with their chunk and arrive home. Under a
sliding window the rotation stops once every remaining pair is outside the
window (and the accumulators jump home in one hop); sinks seed the owner
chunk's LSE; the soft cap applies inside each pair. Segment ids are global
document ids, so packing composes.

Each chunk pair goes through the flash kernels -- K1 forward with a static
`q_offset`, K2/K3 backward with the global LSE and delta -- on CUDA
tensors (`chunk_fwd_kernel`, `chunk_bwd_kernel`), or through the plain
versions, the counterparts of `_chunk_fwd_xla` / `_chunk_bwd_xla`
(`chunk_fwd_torch`, `chunk_bwd_torch`).

The per-step arithmetic (`fwd_step`, `bwd_step`, `merge`) is apart from
the rotation: `ring_attention` rotates with `batch_isend_irecv` over the
sequence group, and `virtual_ring_forward` / `virtual_ring_backward` (and
the autograd `virtual_ring_attention`) drive P chunk owners in one process
with no collectives, in the same order of sums as the real ring.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from llm_training_tpu_torch.ops.attention import make_attention_mask
from llm_training_tpu_torch.ops.kernels.flash_attention import sink_grad


def _safe_weight(lse: torch.Tensor, lse_total: torch.Tensor) -> torch.Tensor:
    """exp(lse - lse_total), with a fully masked row (-inf) weighing 0."""
    finite_total = torch.where(torch.isneginf(lse_total), 0.0, lse_total)
    return torch.where(torch.isneginf(lse), 0.0, torch.exp(lse - finite_total))


def num_steps(n: int, c: int, sliding_window: int | None) -> int:
    """Ring steps with any in-window pair: step s pairs q positions with kv
    positions s chunks older; beyond the window the ring stops."""
    if sliding_window is None:
        return n
    return min(n, (sliding_window + c - 2) // c + 1)


# ------------------------------------------------------------ chunk pairs


def _pair_scores(q, k, seg_q, seg_kv, causal, cap, sliding_window, q_offset):
    """Scores [B, Hkv, G, Cq, Ckv] fp32 (capped) and the visibility mask of
    one chunk pair (scale already folded into q)."""
    batch, c_q, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(batch, c_q, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    mask = make_attention_mask(seg_q, seg_kv, c_q, k.shape[1], causal=causal,
                               sliding_window=sliding_window, q_offset=q_offset)
    return s, mask[:, :, None]


def chunk_fwd_torch(q, k, v, seg_q, seg_kv, *, causal, cap=None, sliding_window=None,
                    q_offset=0):
    """(o fp32 [B, C, Hq, D], lse fp32 [B, Hq, C]) of one chunk pair: the
    counterpart of `_chunk_fwd_xla`. A row that sees nothing gives o = 0,
    lse = -inf."""
    batch, c_q, hq, d = q.shape
    s, mask = _pair_scores(q, k, seg_q, seg_kv, causal, cap, sliding_window, q_offset)
    s = torch.where(mask, s, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.where(mask, torch.exp(s - m_safe), 0.0)
    l = p.sum(-1, keepdim=True)
    lse = torch.where(l[..., 0] > 0, m[..., 0] + torch.log(torch.where(l[..., 0] > 0, l[..., 0], 1.0)),
                      float("-inf"))
    o = torch.einsum("bhgqk,bkhd->bqhgd", p / torch.where(l > 0, l, 1.0), v.float())
    return o.reshape(batch, c_q, hq, d), lse.reshape(batch, hq, c_q)


def chunk_bwd_torch(q, k, v, seg_q, seg_kv, do, lse, delta, *, causal, cap=None,
                    sliding_window=None, q_offset=0):
    """Chunk-pair (dq, dk, dv) in the inputs' types, given the GLOBAL lse
    and delta `[B, Hq, C]` fp32: the counterpart of `_chunk_bwd_xla`."""
    batch, c_q, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    s, mask = _pair_scores(q, k, seg_q, seg_kv, causal, cap, sliding_window, q_offset)
    lse_g = lse.reshape(batch, hkv, group, c_q)[..., None]
    lse_safe = torch.where(torch.isneginf(lse_g), 0.0, lse_g)
    p = torch.where(mask, torch.exp(s - lse_safe), 0.0)
    dog = do.float().reshape(batch, c_q, hkv, group, d)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta.reshape(batch, hkv, group, c_q)[..., None])
    if cap is not None:
        ds = ds * (1.0 - (s / cap) ** 2)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(batch, c_q, hq, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.float().reshape(batch, c_q, hkv, group, d))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_inputs(q, k, v, seg_q, seg_kv):
    from llm_training_tpu_torch.ops.kernels import flash_attention as fa

    return fa.pad_inputs(q, k, v, seg_q.to(torch.int32), seg_kv.to(torch.int32))


def _pad_rows(x: torch.Tensor, length: int) -> torch.Tensor:
    """Pad the last dim of [B, Hq, C] to `length` with zeros."""
    return F.pad(x, (0, length - x.shape[-1])).contiguous()


def chunk_fwd_kernel(q, k, v, seg_q, seg_kv, *, causal, cap=None, sliding_window=None,
                     q_offset=0):
    """`chunk_fwd_torch` through K1: the chunk padded as the flash wrapper
    pads it (segment id 0 rows, head_dim to 64/128/256), the offset static, O
    written in fp32."""
    from llm_training_tpu_torch.ops.kernels import flash_attention as fa

    c_q, d = q.shape[1], q.shape[3]
    qp, kp, vp, sq, skv = _kernel_inputs(q, k, v, seg_q, seg_kv)
    # O in fp32: the owner's partials merge before the one rounding to q's
    # type (JAX's Pallas chunk rounds each partial first)
    o, lse = fa.flash_fwd_kernel(
        qp, kp, vp, sq, skv, fa.tile_ranges(sq), fa.tile_ranges(skv), None,
        q_blocks=fa.tile_ranges(sq, fa.BLOCK), causal=causal, window=int(sliding_window or 0),
        cap=float(cap or 0.0), q_offset=int(q_offset), out_dtype=torch.float32,
    )
    return o[:, :c_q, :, :d], lse[:, :, :c_q]


def chunk_bwd_kernel(q, k, v, seg_q, seg_kv, do, lse, delta, *, causal, cap=None,
                     sliding_window=None, q_offset=0):
    """`chunk_bwd_torch` through K2 (dq) and K3 (dk, dv)."""
    from llm_training_tpu_torch.ops.kernels import flash_attention as fa

    c_q, c_kv, d = q.shape[1], k.shape[1], q.shape[3]
    qp, kp, vp, sq, skv = _kernel_inputs(q, k, v, seg_q, seg_kv)
    dop = fa._pad_to(fa._pad_to(do.to(q.dtype), 1, qp.shape[1]), 3, qp.shape[3]).contiguous()
    lsep, deltap = _pad_rows(lse, qp.shape[1]), _pad_rows(delta, qp.shape[1])
    flat = (qp, kp, vp, sq, skv, fa.tile_ranges(sq), fa.tile_ranges(skv), dop, lsep, deltap)
    hyper = dict(causal=causal, window=int(sliding_window or 0), cap=float(cap or 0.0),
                 q_offset=int(q_offset))
    dq = fa.flash_dq_kernel(*flat, q_blocks=fa.tile_ranges(sq, fa.BLOCK), **hyper)
    dk, dv = fa.flash_dkv_kernel(*flat, k_blocks=fa.tile_ranges(skv, fa.BLOCK), **hyper)
    return dq[:, :c_q, :, :d], dk[:, :c_kv, :, :d], dv[:, :c_kv, :, :d]


def _chunk_fns(q: torch.Tensor, impl: str):
    """(forward, backward) chunk functions of `impl`: 'auto' takes the
    kernels for CUDA tensors and the plain versions for CPU ones;
    'kernel' / 'pallas' the kernels (raising off CUDA); 'torch' / 'xla'
    the plain versions."""
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        raise TypeError("ring attention takes local tensors, not DTensors")
    if impl in ("kernel", "pallas") or (impl == "auto" and q.device.type == "cuda"):
        if q.device.type != "cuda":
            raise ValueError(f"impl={impl!r} runs the CUDA flash kernels; q is on {q.device}")
        return chunk_fwd_kernel, chunk_bwd_kernel
    if impl not in ("auto", "torch", "xla"):
        raise ValueError(f"unknown impl {impl!r}")
    return chunk_fwd_torch, chunk_bwd_torch


# ------------------------------------------------------------ one ring step


def pair_kind(idx: int, s: int) -> tuple[bool, bool]:
    """(visible, causal) of owner `idx`'s q chunk against the kv chunk that
    is `s` chunks older (the one it holds after s rotations)."""
    return (s == 0 or idx >= s), s == 0


def init_acc(q: torch.Tensor, sinks: torch.Tensor | None):
    """The running (o, lse) of an owner: zeros, and -inf or the sinks."""
    batch, c, hq, d = q.shape
    o = torch.zeros((batch, c, hq, d), dtype=torch.float32, device=q.device)
    if sinks is not None:
        lse = sinks.float()[None, :, None].expand(batch, hq, c).clone()
    else:
        lse = torch.full((batch, hq, c), float("-inf"), dtype=torch.float32, device=q.device)
    return o, lse


def merge(o_acc, lse_acc, o_s, lse_s):
    """Fold a pair's (o, lse) into the running ones."""
    lse_new = torch.logaddexp(lse_acc, lse_s)
    w_acc = _safe_weight(lse_acc, lse_new)[..., None].transpose(1, 2)
    w_s = _safe_weight(lse_s, lse_new)[..., None].transpose(1, 2)
    return o_acc * w_acc + o_s * w_s, lse_new


def fwd_step(fwd, q, k, v, seg_q, seg_kv, idx, s, acc, hyper):
    """Owner `idx`'s step s: the pair's attention merged into `acc`."""
    visible, causal = pair_kind(idx, s)
    if not visible:
        return acc
    o_s, lse_s = fwd(q, k, v, seg_q, seg_kv, causal=causal, q_offset=s * q.shape[1], **hyper)
    return merge(*acc, o_s, lse_s)


def bwd_step(bwd, q, k, v, seg_q, seg_kv, do, lse, delta, idx, s, hyper):
    """Owner `idx`'s step-s (dq, dk, dv) in fp32, or None when skipped."""
    visible, causal = pair_kind(idx, s)
    if not visible:
        return None
    grads = bwd(q, k, v, seg_q, seg_kv, do, lse, delta, causal=causal,
                q_offset=s * q.shape[1], **hyper)
    return tuple(g.float() for g in grads)


def row_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) as [B, Hq, C] fp32."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


# ------------------------------------------------------------ the real ring


def _rotate(tensors: list[torch.Tensor], group, hops: int = 1) -> list[torch.Tensor]:
    """Each rank sends its tensors `hops` ranks on round the group's ring and
    receives the ones from `hops` ranks back."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + hops) % n)
    src = dist.get_global_rank(group, (me - hops) % n)
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), dst, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, src, group) for r in out]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, sinks, group, hyper, impl):
        fwd, bwd = _chunk_fns(q, impl)
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        steps = num_steps(n, q.shape[1], hyper["sliding_window"])
        acc = init_acc(q, sinks)
        k_cur, v_cur, seg_cur = k, v, seg
        for s in range(steps):
            acc = fwd_step(fwd, q, k_cur, v_cur, seg, seg_cur, idx, s, acc, hyper)
            if s < steps - 1:
                k_cur, v_cur, seg_cur = _rotate([k_cur, v_cur, seg_cur], group)
        o, lse = acc[0].to(q.dtype), acc[1]
        ctx.save_for_backward(q, k, v, seg, sinks, o, lse)
        ctx.group, ctx.hyper, ctx.bwd = group, hyper, bwd
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, seg, sinks, o, lse = ctx.saved_tensors
        group, hyper = ctx.group, ctx.hyper
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        steps = num_steps(n, q.shape[1], hyper["sliding_window"])
        do = do.contiguous()
        delta = row_delta(do, o)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur, seg_cur = k, v, seg
        for s in range(steps):
            grads = bwd_step(ctx.bwd, q, k_cur, v_cur, seg, seg_cur, do, lse, delta, idx, s,
                             hyper)
            if grads is not None:
                dq += grads[0]
                dk += grads[1]
                dv += grads[2]
            # the kv chunk rotates together with its gradient accumulators
            k_cur, v_cur, seg_cur, dk, dv = _rotate([k_cur, v_cur, seg_cur, dk, dv], group)
        if steps < n:
            # the window cut the ring short: the accumulators jump home
            dk, dv = _rotate([dk, dv], group, hops=n - steps)
        d_sinks = None if sinks is None else sink_grad(sinks, lse, delta)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, d_sinks, None, None, None


def _prepare(q, segment_ids, scale):
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # the scale folded into q, rounded to q's type, as JAX does
    if scale != 1.0:
        q = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    if segment_ids is None:
        segment_ids = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    return q, segment_ids.to(torch.int32)


def ring_attention(q, k, v, segment_ids=None, *, group, sliding_window=None, sinks=None,
                   logits_soft_cap=None, scale=None, impl="auto", return_lse=False):
    """Causal ring attention over this rank's chunk of a sequence-sharded
    batch: q [B, C, Hq, D], k/v [B, C, Hkv, D], segment ids [B, C] with
    GLOBAL document ids, `group` the sequence ranks in chunk order; sinks
    [Hq]. Returns o [B, C, Hq, D] (and the global LSE with `return_lse`)."""
    q, segment_ids = _prepare(q, segment_ids, scale)
    hyper = dict(cap=logits_soft_cap, sliding_window=sliding_window)
    o, lse = _Ring.apply(q, k, v, segment_ids, sinks, group, hyper, impl)
    return (o, lse) if return_lse else o


# ------------------------------------------------------------ the virtual ring


def _chunks(x: torch.Tensor, p: int) -> list[torch.Tensor]:
    return [c.contiguous() for c in x.chunk(p, dim=1)]


def virtual_ring_forward(q, k, v, seg, p, *, sinks=None, logits_soft_cap=None,
                         sliding_window=None, impl="auto"):
    """The ring's forward for P owners of one process over whole-sequence
    inputs (scale folded into q): (o in q's type, lse [B, Hq, S] fp32)."""
    fwd, _ = _chunk_fns(q, impl)
    hyper = dict(cap=logits_soft_cap, sliding_window=sliding_window)
    qs, ks, vs, segs = _chunks(q, p), _chunks(k, p), _chunks(v, p), _chunks(seg, p)
    steps = num_steps(p, qs[0].shape[1], sliding_window)
    accs = [init_acc(qc, sinks) for qc in qs]
    for s in range(steps):
        for idx in range(p):
            j = (idx - s) % p
            accs[idx] = fwd_step(fwd, qs[idx], ks[j], vs[j], segs[idx], segs[j], idx, s,
                                 accs[idx], hyper)
    o = torch.cat([a[0] for a in accs], dim=1).to(q.dtype)
    return o, torch.cat([a[1] for a in accs], dim=2)


def virtual_ring_backward(q, k, v, seg, o, lse, do, p, *, sinks=None, logits_soft_cap=None,
                          sliding_window=None, impl="auto"):
    """The ring's backward for P owners of one process: (dq, dk, dv,
    d_sinks), each chunk's dk/dv summed in the real ring's order."""
    _, bwd = _chunk_fns(q, impl)
    hyper = dict(cap=logits_soft_cap, sliding_window=sliding_window)
    qs, ks, vs, segs = _chunks(q, p), _chunks(k, p), _chunks(v, p), _chunks(seg, p)
    dos, os_ = _chunks(do, p), _chunks(o, p)
    lses = [c.contiguous() for c in lse.chunk(p, dim=2)]
    deltas = [row_delta(dc, oc) for dc, oc in zip(dos, os_)]
    dqs = [torch.zeros(c.shape, dtype=torch.float32, device=c.device) for c in qs]
    dks = [torch.zeros(c.shape, dtype=torch.float32, device=c.device) for c in ks]
    dvs = [torch.zeros(c.shape, dtype=torch.float32, device=c.device) for c in vs]
    for s in range(num_steps(p, qs[0].shape[1], sliding_window)):
        for idx in range(p):
            j = (idx - s) % p
            grads = bwd_step(bwd, qs[idx], ks[j], vs[j], segs[idx], segs[j], dos[idx],
                             lses[idx], deltas[idx], idx, s, hyper)
            if grads is not None:
                dqs[idx] += grads[0]
                dks[j] += grads[1]
                dvs[j] += grads[2]
    d_sinks = None
    if sinks is not None:
        d_sinks = sum(sink_grad(sinks, l, d).float() for l, d in zip(lses, deltas)).to(sinks.dtype)
    cat = lambda xs, like: torch.cat(xs, dim=1).to(like.dtype)  # noqa: E731
    return cat(dqs, q), cat(dks, k), cat(dvs, v), d_sinks


class _VirtualRing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, sinks, p, kw):
        o, lse = virtual_ring_forward(q, k, v, seg, p, sinks=sinks, **kw)
        ctx.save_for_backward(q, k, v, seg, sinks, o, lse)
        ctx.p, ctx.kw = p, kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, sinks, o, lse = ctx.saved_tensors
        dq, dk, dv, d_sinks = virtual_ring_backward(q, k, v, seg, o, lse, do.contiguous(), ctx.p,
                                                    sinks=sinks, **ctx.kw)
        return dq, dk, dv, None, d_sinks, None, None


def virtual_ring_attention(q, k, v, segment_ids=None, *, p, sliding_window=None, sinks=None,
                           logits_soft_cap=None, scale=None, impl="auto"):
    """`ring_attention` over whole-sequence inputs cut into `p` chunks, the
    owners driven in one process (differentiable)."""
    q, segment_ids = _prepare(q, segment_ids, scale)
    kw = dict(logits_soft_cap=logits_soft_cap, sliding_window=sliding_window, impl=impl)
    return _VirtualRing.apply(q, k, v, segment_ids, sinks, p, kw)


def dispatch_ring_attention(q, k, v, segment_ids, *, sliding_window=None, sinks=None,
                            logits_soft_cap=None, scale=None, impl="auto"):
    """`ring_attention` over the active mesh's sequence ranks, or None when
    no mesh with a `sequence` axis above 1 is active (callers then take the
    one-device path). Under tensor parallelism each rank runs its local
    heads."""
    from llm_training_tpu_torch.parallel.mesh import SEQUENCE_AXIS, active_mesh

    mesh = active_mesh()
    if mesh is None or mesh[SEQUENCE_AXIS].size() <= 1:
        return None
    return ring_attention(q, k, v, segment_ids, group=mesh[SEQUENCE_AXIS].get_group(),
                          sliding_window=sliding_window, sinks=sinks,
                          logits_soft_cap=logits_soft_cap, scale=scale, impl=impl)
