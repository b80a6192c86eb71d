"""Ring attention: attention over a sequence sharded across a process group.

Counterpart of zgml_tpu/parallel/ring.py (32-164). Each rank owns one block
of t_loc query positions and the K/V of the same positions; the K/V blocks
rotate around the ring (to the next rank, `mesh.ring_shift`, JAX's
lax.ppermute) while each rank folds every visiting block into its output.
The un-repeated GQA K/V rotate, so the traffic is Hkv-sized.

Two tiers, as the JAX package's:

  kernel (causal, the ring_attention switch on; JAX's
    `_ring_attention_flash`): one K10f launch a hop
    (dispatch.flash_fwd_lse), which returns the hop's normalised o and its
    per-row LSE, at q_offset (idx - owner) * t_loc: the bf16 form over bf16
    K/V where config.prefill_bf16() (the running max stepping per JAX key
    tile, min(128, t_loc rounded up to 8)), else the f32 form over the f32
    K/V (K10f's f32-K/V form, counted flash_fwd_f32kv: JAX's hop attends
    over f32 K/V under ZGML_TPU_PREFILL_BF16=0); the kernel's +inf LSE of a
    row with no live key becomes -inf, and the hops merge by JAX's rescale,
    operation for operation. A hop whose block lies wholly in the future (owner > idx)
    is skipped: its LSE is -inf everywhere, and the merge then returns out
    and lse bit for bit (w1 = exp(0) = 1, w2 = 0), so skipping it changes
    nothing. The hops that run are counted under ``ring_hops``, the skipped
    ones under ``ring_hops_skipped``.
  plain (non-causal, or ZGML_TPU_KERNELS=ref / ZGML_TPU_KERNELS_DISABLE=
    ring_attention; JAX's einsum oracle `_ring_attention_local`): an online
    softmax over the visiting blocks in f32.

Each call counts ``ring_attention`` under the tier its hops ran on: `cuda`
where they launched K10f, `ref` otherwise.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from zgml_tpu_torch import config
from zgml_tpu_torch.ops import dispatch
from zgml_tpu_torch.parallel.mesh import Mesh, ring_shift
from zgml_tpu_torch.runtime.profile import global_profile

NEG_INF = -1e30


def _flash_hop(q, k_cur, v_cur, q_off: int, bf16: bool):
    """One hop through K10f: (o f32 [B, Hq, t, d] normalised within the hop,
    lse f32 [B, Hq, t], -inf where no key is live)."""
    s = k_cur.shape[2]
    # the bf16 form's running max steps per JAX's key tile bk (ring.py:46-48)
    o, lse = dispatch.flash_fwd_lse(q, k_cur, v_cur, kv_len=s, q_offset=q_off, bf16=bf16,
                                    group=min(128, -(-s // 8) * 8))
    return o, torch.where(lse == float("inf"), torch.full_like(lse, float("-inf")), lse)


def _ring_flash(q, k, v, group):
    cp, idx = dist.get_world_size(group), dist.get_rank(group)
    b, hq, t_loc, d = q.shape
    bf16 = config.prefill_bf16()
    kernel = q.is_cuda and dispatch.use_kernel()
    if bf16:                    # the hop rounds them so; rotate half the bytes
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    else:                       # JAX's f32 hop: f32 K/V (K10f's f32-K/V form)
        k, v = k.to(torch.float32), v.to(torch.float32)
    q = q.contiguous()
    out = torch.zeros((b, hq, t_loc, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, hq, t_loc), float("-inf"), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for i in range(cp):
        owner = (idx - i) % cp
        if owner > idx:                      # wholly masked: the merge is the identity
            global_profile.add("ring_hops_skipped")
        else:
            global_profile.add("ring_hops")
            o_i, lse_i = _flash_hop(q, k_cur, v_cur, (idx - owner) * t_loc, bf16)
            m = torch.maximum(lse, lse_i)
            m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
            w1 = torch.where(torch.isneginf(lse), torch.zeros_like(lse), torch.exp(lse - m_safe))
            w2 = torch.where(torch.isneginf(lse_i), torch.zeros_like(lse_i),
                             torch.exp(lse_i - m_safe))
            denom = w1 + w2
            safe_d = torch.where(denom > 0, denom, torch.ones_like(denom))
            out = (out * w1[..., None] + o_i * w2[..., None]) / safe_d[..., None]
            lse = torch.where(denom > 0, m_safe + torch.log(safe_d),
                              torch.full_like(denom, float("-inf")))
        if i + 1 < cp:
            k_cur, v_cur = ring_shift([k_cur, v_cur], group)
    global_profile.count_op("ring_attention", "cuda" if kernel else "ref")
    return out.to(q.dtype)


def _ring_plain(q, k, v, group, causal: bool):
    cp, idx = dist.get_world_size(group), dist.get_rank(group)
    b, hq, t_loc, d = q.shape
    hkv = k.shape[1]
    n_rep = hq // hkv
    scale = 1.0 / d ** 0.5
    qf = q.to(torch.float32).reshape(b, hkv, n_rep, t_loc, d)
    m = torch.full((b, hkv, n_rep, t_loc, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, n_rep, t_loc, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    qi = torch.arange(t_loc, device=q.device)[:, None] + idx * t_loc
    for i in range(cp):
        owner = (idx - i) % cp                       # whose K/V block this is
        s = torch.einsum("bhrqd,bhkd->bhrqk", qf, k_cur.to(torch.float32)) * scale
        if causal:
            ki = torch.arange(t_loc, device=q.device)[None, :] + owner * t_loc
            s = torch.where(ki <= qi, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhrqk,bhkd->bhrqd", p, v_cur.to(torch.float32))
        m = m_new
        if i + 1 < cp:
            k_cur, v_cur = ring_shift([k_cur, v_cur], group)
    safe = torch.where(l > 0, l, torch.ones_like(l))
    global_profile.count_op("ring_attention", "ref")
    return (acc / safe).reshape(b, hq, t_loc, d).to(q.dtype)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                         causal: bool = True) -> torch.Tensor:
    """This rank's block of attention over the ring `group`: q [B, Hq, t_loc,
    d], k / v [B, Hkv, t_loc, d] (positions idx * t_loc + arange(t_loc), idx
    the rank in the group) -> [B, Hq, t_loc, d] in q's dtype. The kernel tier
    where causal and config.kernel_on("ring_attention"), else the plain one.
    Every rank of the group calls it together."""
    if causal and config.kernel_on("ring_attention"):
        return _ring_flash(q, k, v, group)
    return _ring_plain(q, k, v, group, causal)


def make_ring_attention(mesh: Mesh, axis: str = "tp", causal: bool = True):
    """The rank-local ring attention over the mesh axis `axis`
    (make_ring_attention, ring.py:156-164): fn(q, k, v) on this rank's
    sequence block."""
    group = mesh.groups[axis]

    def fn(q, k, v):
        return ring_attention_local(q, k, v, group, causal)

    return fn
