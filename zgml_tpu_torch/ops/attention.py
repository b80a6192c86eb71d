"""K3/K4 and K9/K8: flash prefill and decode attention over the bf16 and the
int8 KV cache, kernels and plain versions.

Counterpart of zgml_tpu/ops/attention.py `_flash_kernel` (K3),
`_decode_kernel` (K4), `_flash_q8_kernel` (K9) and `_decode_q8_kernel` (K8),
with the JAX package's layouts at the public functions except the int8
cache's, which is position-major as the bf16 one (quant/kv_cache.py):

  q       f32  [B, Hq, Tq, d]        (Tq = 1 for decode)
  k, v    bf16 [R, Hkv, S, d]        the KV cache slab, read in place; batch
                                     row b of the query reads cache row
                                     kv_row + b (the stacked [L, B, ...] cache
                                     viewed as [L*B, ...], kv_row = layer * B)
       or f32  [R, Hkv, S, d]        the f32 KV cache (init_cache(b, "f32")):
                                     K3's f32-K/V forms and K4's f32 form
                                     (also Whisper's f32 self cache and
                                     cross K / V), the JAX kernels' cast of
                                     any cache to their operand dtype
       or int8 [R, Hkv, S, d] with ks, vs f32 [R, Hkv, S], one scale per
                                     position (K8, K9)

``*_cuda`` launch csrc/flash_attn.cu and csrc/decode_attn.cu (the int8
cache is a mode of each); ``*_ref`` are the plain torch versions, with the
masks of zgml_tpu/ops/dispatch.py (177-188, 237-246). The int8 ones compute
the kernels' functions, not the JAX ref tier's dequantize-then-attend:
K8 quantizes q per query head (attention.py:529-533) and takes integer
q.k dots, K9 keeps q f32 in its f32 form (ZGML_TPU_PREFILL_BF16=0); both
fold the per-position scales into the scores and into p.
Callers go through ``ops.dispatch``.

K8 has a second function under ZGML_TPU_ATTN_I8PV=1 (config.attn_i8pv(),
attention.py:384-392, 440-448): per JAX key block of ``k8_block(S)`` keys
the running max steps to the block's, p * v_scale is quantized to int8
against the block's own max (psc = max / 127, pq = round-half-even(pv /
psc)), P.V runs exactly in integers and the block adds o_i32 * psc; l is
the sum of the unrounded p. ``decode_attention_q8_ref(i8pv=True)`` is it,
with ``split``: the plain version of the kernel's plan (each split's
running max from its first block, then the merge); the launches count
under decode_attention_q8_i8pv.

Under ZGML_TPU_PREFILL_BF16 (config.prefill_bf16(), default on) K3, K9 and
K10f take their bf16 form, the JAX kernels' function at bf16=True
(attention.py:77-104, 625-644; flash_vjp.py:60-84): scores from bf16(q)
and the bf16 K (K9: the int8 levels) with f32 sums, times scale (K9:
k_scale * scale); an f32 online softmax whose running max steps once per
JAX key tile of ``flash_group`` keys from key 0; p (K9: p * v_scale)
rounded to bf16 against bf16 V (K9: levels), f32 sums; l the sum of the
unrounded p. The plain versions take bf16=True (``grouped_softmax_pv``);
the bf16 launches count under attention_bf16, flash_attention_q8_bf16 and
flash_fwd_bf16.

Over f32 K / V (the f32 cache) K3 has both forms as the JAX kernel does
(attention.py:81-84, 107: K and V cast to the operand dtype): the bf16 form
is K3's bf16 form over bf16(K), bf16(V) (rounded to nearest even, as astype
rounds), the f32 form the f32 function on the f32 K / V (3xTF32 dots, the
ring hop's K10f f32-K/V form without the LSE); counted under
attention_bf16_f32kv and attention_f32kv (``flash_counter``).

The prefill kernel (K3, K9 and K10f, csrc/flash_attn.cu) packs the n_rep
query heads of a KV head into tiles of FLASH_BM rows, position-major, and
may split each tile's live prefix across blocks. ``flash_split_plan`` picks
the split from the shapes, the SM count and the blocks an SM holds
(``flash_plan`` asks the card for both); ``flash_partials_ref`` and
``combine_partials_ref`` are the kernel's two stages in torch (each
split's unnormalised o, m and l, then their merge), which the CPU tests
hold to the one-stage plain versions.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from zgml_tpu_torch.ops import build, coop, decode_plan, refs
from zgml_tpu_torch.quant.kv_cache import quantize_columns
from zgml_tpu_torch.runtime.profile import global_profile

HEAD_DIMS = (16, 32, 64, 128)     # compiled instantiations of K3, K4, K8 and K9

# The prefill kernel's tiling (csrc/flash_attn.cu FA_BM, FaShape::BN) and its
# split policy: fill the blocks the card holds at once (its SMs times the
# instantiation's blocks per SM, which the card reports; FLASH_BLOCKS_PER_SM
# where no card is asked, its value at head_dim 128) in one wave, give each
# split at least FLASH_MIN_KEY_TILES key tiles (each split restages q and adds
# a partial to the combine), and at most FLASH_MAX_SPLIT splits.
FLASH_BM = 64
FLASH_BLOCKS_PER_SM = 2
FLASH_MIN_KEY_TILES = 2
FLASH_MAX_SPLIT = 16


def flash_bn(d: int) -> int:
    """Keys per K/V tile of the prefill kernel at head_dim d (f32 form)."""
    return 32 if d == 128 else 64


def flash_group(s: int, kv8: bool) -> int:
    """Keys of one JAX flash tile over a cache of s positions, the step of
    the bf16 form's running max: K3 / K10f's bk (attention.py:282-290, bk
    128: halved while it does not divide s, down to 8; 128 over a padded
    cache where none divides), K9's (attention.py:762-772, bk 256: 128
    where 256 does not divide s, s below 256)."""
    if kv8:
        bk = min(256, s)
        while bk >= 256 and s % bk:
            bk //= 2
        return bk if s % bk == 0 else 128
    bk = min(128, s)
    while bk >= 16 and s % bk:
        bk //= 2
    return bk if s % bk == 0 else 128


def k8_block(s: int) -> int:
    """Keys of one JAX block of K8 over a cache of s positions, the unit its
    I8PV mode quantizes p against (bs_eff, attention.py:536-545, bs 256):
    256 where 256 divides s, s below 256, else 128 over the cache padded up
    (the padded keys are masked); K9's tile takes the same rule."""
    return flash_group(s, kv8=True)


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How the prefill kernel cuts one call: row tiles of ``bm`` packed rows
    (row r = position r // n_rep of query head hk * n_rep + r % n_rep), key
    tiles of ``bn``, and each row tile's key tiles split over ``n_split``
    blocks. The kernel does this arithmetic itself (tile_key_end, and the
    split's [kt0, kt1)); these methods are the same formulas."""
    bm: int
    bn: int
    n_rep: int
    tq: int
    kv_len: int
    q_offset: int
    n_split: int

    @property
    def n_m(self) -> int:
        return -(-self.n_rep * self.tq // self.bm)

    def tile_key_end(self, m: int) -> int:
        """One past the last key any row of row tile m attends."""
        last = min(self.n_rep * self.tq, (m + 1) * self.bm) - 1
        return max(0, min(self.kv_len, self.q_offset + last // self.n_rep + 1))

    def split_keys(self, m: int, s: int) -> tuple[int, int]:
        """Keys [k0, k1) of row tile m that split s takes: key tiles
        [s * n // n_split, (s + 1) * n // n_split) of the tile's n."""
        end = self.tile_key_end(m)
        n = -(-end // self.bn)
        kt0, kt1 = s * n // self.n_split, (s + 1) * n // self.n_split
        return min(kt0 * self.bn, end), min(kt1 * self.bn, end)


def flash_split_plan(b: int, hq: int, hkv: int, tq: int, d: int, kv_len: int, q_offset: int,
                     sm_count: int, per_sm: int = FLASH_BLOCKS_PER_SM,
                     bn: int | None = None) -> FlashPlan:
    """The prefill kernel's plan for q [b, hq, tq, d] over keys j < kv_len
    at q_offset on a card of sm_count SMs that each hold per_sm blocks: split
    the live prefix into as many parts as one wave of blocks has room for
    beside the tiles (so a split never adds a second, mostly idle wave), and
    no further than the longest tile has key tiles for. A pure function of
    the shapes and the card, so K3 and K10f on the same inputs take the same
    plan (and K10f's O stays K3's bit for bit). `bn`: the key tile of
    another kernel with these row tiles (K10dq) or the bf16 form's group
    (its splits start on a group), else flash_bn(d)."""
    n_rep, bn = hq // hkv, bn or flash_bn(d)
    kv_len = max(0, kv_len)
    tiles = b * hkv * -(-n_rep * tq // FLASH_BM)
    longest = -(-max(0, min(kv_len, q_offset + tq)) // bn)
    want = per_sm * sm_count // tiles
    n_split = max(1, min(want, longest // FLASH_MIN_KEY_TILES, FLASH_MAX_SPLIT))
    return FlashPlan(FLASH_BM, bn, n_rep, tq, kv_len, q_offset, n_split)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, d: int, kv: int, bf16: bool = False) -> int:
    """Blocks of the prefill kernel an SM of card `index` holds at head_dim
    d: over the bf16 cache (kv 0), the int8 one (1) or f32 K/V (2, K10f's
    f32-K/V form); bf16: the bf16 form."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        build.check(build.library().zgml_flash_blocks_per_sm(d, int(kv), int(bf16),
                                                             ctypes.byref(n)),
                    "flash occupancy")
    if n.value < 1:
        raise RuntimeError(f"flash attention (head_dim {d}): no block fits on an SM")
    return n.value


def flash_plan(q, k, kv_len, q_offset: int, kv8: bool, group: int | None = None) -> FlashPlan:
    """The plan a launch of the prefill kernel takes for q and the cache k
    on q's card (its SM count and the instantiation's blocks per SM); with
    `group` (the bf16 form's keys a running-max step) its splits start on a
    group, over bf16 or f32 K / V alike."""
    b, hq, tq, d = q.shape
    _, hkv, s, _ = k.shape
    kv_len = s if kv_len is None else min(int(kv_len), s)
    index = q.device.index or 0
    # the bf16 form over f32 K / V takes the bf16 cache's plan: a split moves
    # where p rounds, and with one plan its output is the bf16 cache's on the
    # rounded K / V bit for bit (csrc/flash_attn.cu, the bf16 form's note)
    kv = 1 if kv8 else 2 if k.dtype == torch.float32 and group is None else 0
    return flash_split_plan(b, hq, hkv, tq, d, kv_len, int(q_offset), _sm_count(index),
                            _blocks_per_sm(index, d, kv, group is not None), bn=group)


def grouped_softmax_pv(sc: torch.Tensor, v: torch.Tensor, vs: torch.Tensor | None,
                       group: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 form's softmax and P.V over keys [0, K) that start on a
    group: sc f32 [..., R, K] scores (masked keys -inf), v [..., K, d]
    values (bf16, or int8 levels), vs [..., K] f32 V scales or None. The
    running max m_t steps once per `group` keys, as the JAX kernel's per
    key tile (attention.py:92-104); key j's p = exp(s_j - m_t(j)) in f32,
    (p * vs) rounded to bf16 against v, f32 sums; group t's sums join with
    weight exp(m_t - m), all in sc's dtype (f32, or f64 for a check's exact
    evaluation of the same roundings). Returns (o [..., R, d] unnormalised,
    the final max m [..., R] (-inf where no key is live), l [..., R] the sum
    of the unrounded p), o and l relative to m."""
    n = sc.shape[-1]
    g = -(-n // group)
    pad = g * group - n
    if pad:
        sc = torch.nn.functional.pad(sc, (0, pad), value=float("-inf"))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        if vs is not None:
            vs = torch.nn.functional.pad(vs, (0, pad))
    sg = sc.reshape(*sc.shape[:-1], g, group)                          # [..., R, G, gk]
    mt = torch.cummax(sg.amax(dim=-1), dim=-1).values                  # running max [..., R, G]
    live = torch.isfinite(mt)
    mu = torch.where(live, mt, torch.zeros_like(mt))
    p = torch.exp(sg - mu[..., None])                                  # masked: exp(-inf) = 0
    lt = p.sum(dim=-1)
    pv = p if vs is None else p * vs.reshape(*vs.shape[:-1], 1, g, group)
    vg = v.to(sc.dtype).reshape(*v.shape[:-2], g, group, v.shape[-1])
    ot = torch.einsum("...rgk,...gkd->...rgd", refs.bf16_round(pv), vg)
    m = mt[..., -1]
    w = torch.where(live, torch.exp(mu - torch.where(torch.isfinite(m), m,
                                                     torch.zeros_like(m))[..., None]),
                    torch.zeros_like(mu))
    return (w[..., None] * ot).sum(dim=-2), m, (w * lt).sum(dim=-1)


def normalised(o: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """o / l per row, 0 where l is 0 (no live key)."""
    some = l > 0
    return torch.where(some[..., None], o / torch.where(some, l, torch.ones_like(l))[..., None],
                       torch.zeros_like(o))


def flash_attention_ref(q, k, v, kv_len=None, q_offset: int = 0, kv_row: int = 0,
                        bf16: bool = False, group: int | None = None,
                        scale: float | None = None):
    """Causal GQA prefill attention: query row i (absolute q_offset + i)
    attends keys j < kv_len with j <= q_offset + i. bf16: K3's bf16 form
    (the module note; over f32 K / V, on their bf16 roundings), its running
    max stepping every `group` keys (flash_group of the cache length where
    None), its scores scaled by `scale` (1/sqrt(d) where None; a check moves
    it by a few ulps to see which p roundings flip)."""
    b, hq, tq, d = q.shape
    k, v = k[kv_row:kv_row + b], v[kv_row:kv_row + b]
    s = k.shape[2]
    if kv_len is None:
        kv_len = s
    ki = torch.arange(s, device=q.device)[None, :]
    qi = torch.arange(tq, device=q.device)[:, None] + q_offset
    mask = (ki < kv_len) & (ki <= qi)                       # [Tq, S]
    if not bf16:
        return refs.gqa_attention_ref(q, k, v, mask[None, None])
    if k.dtype == torch.float32:                 # f32 K / V: the bf16 form reads bf16(K), bf16(V)
        k, v = refs.bf16_round(k), refs.bf16_round(v)
    hkv = k.shape[1]
    qg = refs.bf16_round(q.to(torch.float32)).reshape(b, hkv, hq // hkv, tq, d)
    sc = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.to(torch.float32)) * (scale or 1.0 / d ** 0.5)
    sc = torch.where(mask, sc, torch.full_like(sc, float("-inf")))
    o, _, l = grouped_softmax_pv(sc, v[:, :, None], None, group or flash_group(s, False))
    return normalised(o, l).reshape(b, hq, tq, d)


def decode_attention_ref(q, k, v, kv_len, kv_row: int = 0):
    """One query token per batch row over the cache prefix: row b attends
    keys j < kv_len[b] (kv_len an int or an int tensor [B])."""
    b = q.shape[0]
    k, v = k[kv_row:kv_row + b], v[kv_row:kv_row + b]
    s = k.shape[2]
    lens = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(s, device=q.device)[None, :] < lens  # [B or 1, S]
    return refs.gqa_attention_ref(q, k, v, valid[:, None, None, :])


def softmax_pv(s: torch.Tensor, v: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """The P.V half of the int8-cache kernels: s f32 [..., R, S] scores
    (masked keys -inf), v [..., S, d] levels (or values), vs [..., S] their
    scales -> f32 [..., R, d] = sum_j (p_j * vs_j) * v_j / l with p = exp(s -
    max), l = sum p (the V scales folded into p, as attention.py:439 and
    layerkernel.py:262-267); a row with no live key gives 0."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("...rs,...sd->...rd", p * vs[..., None, :], v.to(torch.float32))
    return o / torch.where(l > 0, l, torch.ones_like(l))


def _rows(kv_row: int, b: int, *tensors):
    return [t[kv_row:kv_row + b] for t in tensors]


def decode_attention_q8_ref(q, k, ks, v, vs, kv_len, kv_row: int = 0, i8pv: bool = False,
                            split: int | None = None, scale: float | None = None,
                            block: int | None = None):
    """K8's function: one query token per batch row over the int8 cache
    prefix j < kv_len[b]. q is quantized per query head as the kernel does
    (quantize_columns over d), the scores are the exact integer dots times
    q_scale * k_scale * `scale` (1/sqrt(d) where None; attention.py:425-426).
    f32-p (i8pv False): P.V in f32 on the int8 levels with the V scales
    folded into p. i8pv: the ZGML_TPU_ATTN_I8PV function (the module note)
    over JAX blocks of `block` keys (k8_block(S) where None), the row's
    blocks cut into `split` parts as the kernel's plan cuts them
    (decode_plan.decode_split_keys in whole blocks; one where None, JAX's
    function), each with its own running max, merged as combine_partials_ref."""
    b, hq, _, d = q.shape
    k, ks, v, vs = _rows(kv_row, b, k, ks, v, vs)
    hkv, s = k.shape[1], k.shape[2]
    qq, qs = quantize_columns(q.reshape(b, hkv, hq // hkv, d))     # [B, Hkv, n_rep, d]
    # integers below 2^24 (|level| <= 127, d <= 256): exact in f32 in any order
    dots = torch.einsum("bgrd,bgsd->bgrs", qq.to(torch.float32), k.to(torch.float32))
    sc = qs[..., None] * ks[:, :, None, :] * (scale or 1.0 / d ** 0.5)
    lens = torch.clamp(torch.as_tensor(kv_len, device=q.device).reshape(-1), 0, s)
    lens = lens.expand(b).reshape(b, 1, 1, 1)
    ki = torch.arange(s, device=q.device)[None, None, None, :]
    scores = torch.where(ki < lens, dots * sc, torch.full_like(dots, float("-inf")))
    if not i8pv:
        return softmax_pv(scores, v, vs).reshape(b, hq, 1, d)
    bs, n_split = block or k8_block(s), split or 1
    n_blk = -(-lens // bs)                                        # the row's live blocks
    parts = []
    for si in range(n_split):
        lo = torch.minimum(si * n_blk // n_split * bs, lens)
        hi = torch.minimum((si + 1) * n_blk // n_split * bs, lens)
        mine = torch.where((ki >= lo) & (ki < hi), scores, torch.full_like(scores, float("-inf")))
        parts.append(_i8pv_blocks(mine, v, vs, bs))
    o, _ = combine_partials_ref(*(torch.stack(x) for x in zip(*parts)))
    return o.reshape(b, hq, 1, d)


def _i8pv_blocks(scores, v, vs, bs: int):
    """The I8PV online pass over keys [0, S) in blocks of bs (a key of
    score -inf adds nothing, a block without a live key leaves the state as
    it was): scores [B, Hkv, R, S] f32, v [B, Hkv, S, d] int8 levels, vs
    [B, Hkv, S] -> (o [B, Hkv, R, d] unnormalised, m [B, Hkv, R] (-inf where
    no key is live), l [B, Hkv, R]), as attention.py:428-448 per block."""
    s_len = scores.shape[-1]
    m = torch.full(scores.shape[:-1], float("-inf"), device=scores.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((*m.shape, v.shape[-1]), device=scores.device)
    for t0 in range(0, s_len, bs):
        st = scores[..., t0:t0 + bs]
        m_new = torch.maximum(m, st.amax(dim=-1))
        live = torch.isfinite(m_new)
        mu = torch.where(live, m_new, torch.zeros_like(m_new))
        alpha = torch.where(live, torch.exp(m - mu), torch.zeros_like(mu))
        p = torch.exp(st - mu[..., None])                            # masked: exp(-inf) = 0
        l = l * alpha + p.sum(dim=-1)
        pv = p * vs[:, :, None, t0:t0 + bs]
        psc = pv.amax(dim=-1) / 127.0                                # pv >= 0
        pinv = torch.where(psc > 0, 1.0 / torch.where(psc > 0, psc, torch.ones_like(psc)),
                           torch.zeros_like(psc))
        pq = torch.round(pv * pinv[..., None])                       # half to even, as rint
        # the integer P.V, exact in float64 (|sum| <= 256 * 127 * 127)
        o_i = torch.einsum("bgrs,bgsd->bgrd", pq.double(), v[:, :, t0:t0 + bs].double())
        acc = acc * alpha[..., None] + o_i.float() * psc[..., None]
        m = m_new
    return acc, m, l


def flash_attention_q8_ref(q, k, ks, v, vs, kv_len=None, q_offset: int = 0, kv_row: int = 0,
                           bf16: bool = False, group: int | None = None,
                           scale: float | None = None):
    """K9's function: causal GQA prefill over the int8 cache, q f32, scores
    (q . k_levels) * (k_scale * 1/sqrt(d)) (attention.py:629-631), query row
    i (absolute q_offset + i) attending keys j < kv_len with j <= q_offset +
    i, P.V with the V scales folded into p. bf16: K9's bf16 form (q rounded
    to bf16, bf16(p * v_scale) against the levels, the running max stepping
    every `group` keys, flash_group(S, kv8=True) where None; `scale` as
    flash_attention_ref's)."""
    b, hq, tq, d = q.shape
    k, ks, v, vs = _rows(kv_row, b, k, ks, v, vs)
    hkv, s = k.shape[1], k.shape[2]
    if kv_len is None:
        kv_len = s
    qg = q.to(torch.float32).reshape(b, hkv, hq // hkv * tq, d)     # rows (rep, i)
    if bf16:
        qg = refs.bf16_round(qg)
    dots = torch.einsum("bgrd,bgsd->bgrs", qg, k.to(torch.float32))
    scores = dots * (ks * (scale or 1.0 / d ** 0.5))[:, :, None, :]
    ki = torch.arange(s, device=q.device)[None, :]
    qi = torch.arange(qg.shape[2], device=q.device)[:, None] % tq + q_offset
    mask = (ki < kv_len) & (ki <= qi)
    scores = torch.where(mask, scores, torch.full_like(scores, float("-inf")))
    if not bf16:
        return softmax_pv(scores, v, vs).reshape(b, hq, tq, d)
    o, _, l = grouped_softmax_pv(scores, v, vs, group or flash_group(s, True))
    return normalised(o, l).reshape(b, hq, tq, d)


def _packed(q, hkv):
    """q [B, Hq, Tq, d] -> [B, Hkv, n_rep * Tq, d], rows (position, rep)."""
    b, hq, tq, d = q.shape
    return q.reshape(b, hkv, hq // hkv, tq, d).transpose(2, 3).reshape(b, hkv, -1, d)


def flash_partials_ref(q, k, v, kv_len=None, q_offset: int = 0, kv_row: int = 0,
                       plan: FlashPlan | None = None, ks=None, vs=None, bf16: bool = False,
                       exact: bool = False, scale: float | None = None):
    """The prefill kernel's first stage in torch: for each split s of
    `plan` (one split if None) and each row, the split's unnormalised o
    (sum of (p * v_scale) v over its live keys, p = exp(s - m)), its max m
    (-inf where it has no live key) and l = sum p. bf16 cache (K3 / K10f)
    or, with ks and vs, the int8 one (K9). Returns (o [n_split, B, Hq, Tq,
    d], m [n_split, B, Hq, Tq], l [n_split, B, Hq, Tq]), f32 as the kernel
    stores them, each summed in float64 and rounded once: held to the
    one-stage f32 versions, the difference is then the split and the merge,
    not a second f32 summation order over a long prefix. bf16: the bf16
    form's partials, in f32 as the kernel computes them (its p rounds
    against an f32 max), each split's running max stepping every plan.bn
    keys from the split's first key (grouped_softmax_pv); with exact, the
    same roundings evaluated in float64 (bf16(q), p rounded to bf16 against
    the float64 max), returned in float64; `scale` as
    flash_attention_ref's."""
    b, hq, tq, d = q.shape
    if ks is None:
        k, v = _rows(kv_row, b, k, v)
        if bf16 and k.dtype == torch.float32:      # the f32 cache's bf16 form
            k, v = refs.bf16_round(k), refs.bf16_round(v)
    else:
        k, ks, v, vs = _rows(kv_row, b, k, ks, v, vs)
    hkv, s_len = k.shape[1], k.shape[2]
    kv_len = s_len if kv_len is None else min(int(kv_len), s_len)
    if plan is None:
        bn = flash_group(s_len, ks is not None) if bf16 else flash_bn(d)
        plan = FlashPlan(FLASH_BM, bn, hq // hkv, tq, max(0, kv_len), q_offset, 1)
    f64 = torch.float64
    scale = scale or 1.0 / d ** 0.5
    qp = _packed(q.to(torch.float32).to(f64), hkv)             # [B, Hkv, R, d]
    rows = qp.shape[2]
    pos = torch.arange(rows, device=q.device) // plan.n_rep + q_offset
    lim = torch.clamp(torch.minimum(pos + 1, torch.full_like(pos, kv_len)), min=0)
    kf, vf = k.to(f64), v.to(f64)
    qb = refs.bf16_round(_packed(q.to(torch.float32), hkv)) if bf16 else None
    if ks is not None:      # k_scale * scale rounded to f32, as the kernel takes it
        ksc32, vs32 = ks.to(torch.float32) * scale, vs.to(torch.float32)
        ksc, vs = ksc32.to(f64), vs32.to(f64)
    po = torch.zeros((plan.n_split, b, hkv, rows, d), dtype=f64, device=q.device)
    pm = torch.full((plan.n_split, b, hkv, rows), float("-inf"), dtype=f64, device=q.device)
    pl = torch.zeros((plan.n_split, b, hkv, rows), dtype=f64, device=q.device)
    for m in range(plan.n_m):
        r0, r1 = m * plan.bm, min(rows, (m + 1) * plan.bm)
        for si in range(plan.n_split):
            k0, k1 = plan.split_keys(m, si)
            if k0 >= k1:
                continue
            live = torch.arange(k0, k1, device=q.device)[None, :] < lim[r0:r1, None]
            if bf16:
                dt = f64 if exact else torch.float32
                sc = torch.einsum("bgrd,bgkd->bgrk", qb[:, :, r0:r1].to(dt),
                                  k[:, :, k0:k1].to(dt))
                sc = sc * (scale if ks is None else ksc32[:, :, None, k0:k1].to(dt))
                sc = torch.where(live, sc, torch.full_like(sc, float("-inf")))
                o_, m_, l_ = grouped_softmax_pv(sc, v[:, :, k0:k1],
                                                None if vs is None else vs32[:, :, k0:k1].to(dt),
                                                plan.bn)
                po[si, :, :, r0:r1], pm[si, :, :, r0:r1], pl[si, :, :, r0:r1] = o_, m_, l_
                continue
            sc = torch.einsum("bgrd,bgkd->bgrk", qp[:, :, r0:r1], kf[:, :, k0:k1])
            sc = sc * (scale if ks is None else ksc[:, :, None, k0:k1])
            sc = torch.where(live, sc, torch.full_like(sc, float("-inf")))
            mx = sc.amax(dim=-1)
            p = torch.exp(sc - torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))[..., None])
            pv = p if vs is None else p * vs[:, :, None, k0:k1]
            po[si, :, :, r0:r1] = torch.einsum("bgrk,bgkd->bgrd", pv, vf[:, :, k0:k1])
            pm[si, :, :, r0:r1] = mx
            pl[si, :, :, r0:r1] = p.sum(dim=-1)

    def unpack(x):      # [n_split, B, Hkv, R, ...] -> f32 [n_split, B, Hq, Tq, ...]
        x = x.reshape(plan.n_split, b, hkv, tq, plan.n_rep, *x.shape[4:])
        x = x.transpose(3, 4).reshape(plan.n_split, b, hq, tq, *x.shape[5:])
        return x if exact else x.to(torch.float32)
    return unpack(po), unpack(pm), unpack(pl)


def combine_partials_ref(po, pm, pl):
    """The prefill kernel's second stage: merge the splits' partials into
    (o [B, Hq, Tq, d], lse [B, Hq, Tq]); splits with l = 0 add nothing, and
    a row with no live key in any split gives o = 0 and lse = +inf."""
    live = pl > 0
    mx = torch.where(live, pm, torch.full_like(pm, float("-inf"))).amax(dim=0)
    w = torch.where(live, torch.exp(pm - torch.where(torch.isfinite(mx), mx,
                                                     torch.zeros_like(mx))), torch.zeros_like(pm))
    den = (w * pl).sum(dim=0)
    num = (w[..., None] * po).sum(dim=0)
    some = den > 0
    o = torch.where(some[..., None], num / torch.where(some, den, torch.ones_like(den))[..., None],
                    torch.zeros_like(num))
    lse = torch.where(some, mx + torch.log(torch.where(some, den, torch.ones_like(den))),
                      torch.full_like(den, float("inf")))
    return o, lse


def check_qkv(name: str, q, k, v, kv_row: int, tq: int | None, scales=None,
              kv_dtype: torch.dtype = torch.bfloat16):
    """Raise ValueError unless q, k, v (and the int8 cache's scales) are
    what a kernel launch takes: one CUDA device, q f32, k and v both of
    `kv_dtype` (bf16; float32 for K4's f32 form; int8 where scales are
    given), a compiled head dim, contiguous and 16-byte aligned. The dtypes
    are checked before the device."""
    def require(cond, msg):
        if not cond:
            raise ValueError(f"{name}: {msg}")
    require(q.dtype == torch.float32, f"q must be float32, got {q.dtype}")
    want = kv_dtype if scales is None else torch.int8
    require(k.dtype == want and v.dtype == want, f"k/v must be {want}, got {k.dtype}/{v.dtype}")
    require(q.is_cuda and k.device == q.device and v.device == q.device,
            f"q on {q.device}, k on {k.device}, v on {v.device}: one CUDA device")
    require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: want 4-d, k == v")
    b, hq, t, d = q.shape
    r, hkv, _, dk = k.shape
    require(d == dk and d in HEAD_DIMS, f"head_dim {d} (cache {dk}) not in {HEAD_DIMS}")
    require(hkv > 0 and hq % hkv == 0, f"Hq={hq} not a multiple of Hkv={hkv}")
    require(tq is None or t == tq, f"q has Tq={t}, want {tq}")
    require(0 <= kv_row and kv_row + b <= r, f"kv_row {kv_row} + B {b} exceeds cache rows {r}")
    require(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
            "q, k and v must be contiguous")
    require(all(t_.data_ptr() % 16 == 0 for t_ in (q, k, v)), "q, k, v must be 16-byte aligned")
    if scales is not None:
        require(all(t_.device == q.device and t_.dtype == torch.float32
                    and t_.shape == k.shape[:3] and t_.is_contiguous() for t_ in scales),
                f"ks/vs must be contiguous float32 {tuple(k.shape[:3])} on {q.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def counter(name: str, bf16: bool) -> str:
    """The placement counter of flash kernel `name` (attention = K3,
    flash_attention_q8 = K9, flash_fwd = K10f, flash_dq, flash_dkv) in its
    f32 or its bf16 form."""
    return f"{name}_bf16" if bf16 else name


def flash_counter(k: torch.Tensor, bf16: bool) -> str:
    """K3's placement counter over a cache of k's dtype: attention(_bf16)
    over bf16 K / V, attention(_bf16)_f32kv over f32 K / V."""
    return counter("attention", bf16) + ("_f32kv" if k.dtype == torch.float32 else "")


def flash_attention_cuda(q, k, v, kv_len=None, q_offset: int = 0, kv_row: int = 0,
                         bf16: bool = False, group: int | None = None):
    """Launch K3 over bf16 or f32 K / V (bf16: its bf16 form, the running
    max stepping every `group` keys, flash_group of the cache length where
    None; over f32 K / V it reads their bf16 roundings). kv_len, q_offset
    and kv_row are host ints. Counted under flash_counter(k, bf16)."""
    check_qkv("attention", q, k, v, kv_row, None,
              kv_dtype=torch.float32 if k.dtype == torch.float32 else torch.bfloat16)
    o, _ = launch_flash(q, k, None, v, None, kv_len, q_offset, kv_row, lse=False,
                        group=(group or flash_group(k.shape[2], False)) if bf16 else None)
    global_profile.count_op(flash_counter(k, bf16), "cuda")
    return o


def flash_attention_q8_cuda(q, k, ks, v, vs, kv_len=None, q_offset: int = 0, kv_row: int = 0,
                            bf16: bool = False, group: int | None = None):
    """Launch K9 (K3's int8-cache mode; bf16 and group as K3's). kv_len,
    q_offset, kv_row host ints."""
    check_qkv("flash_attention_q8", q, k, v, kv_row, None, (ks, vs))
    o, _ = launch_flash(q, k, ks, v, vs, kv_len, q_offset, kv_row, lse=False,
                        group=(group or flash_group(k.shape[2], True)) if bf16 else None)
    global_profile.count_op(counter("flash_attention_q8", bf16), "cuda")
    return o


def launch_flash(q, k, ks, v, vs, kv_len, q_offset, kv_row, lse: bool,
                 group: int | None = None):
    """One launch of csrc/flash_attn.cu on checked inputs, with the plan of
    flash_split_plan for this card (and its combine pass when the plan
    splits): (o, lse or None); with `group`, the bf16 form whose running max
    steps every `group` keys. The caller counts the launch under its name
    (K3, K9 or K10f)."""
    b, hq, tq, d = q.shape
    _, hkv, s, _ = k.shape
    kv_len = s if kv_len is None else int(kv_len)
    plan = flash_plan(q, k, kv_len, q_offset, ks is not None, group)
    o = torch.empty_like(q)
    lse_t = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device) if lse else None
    part = None
    if plan.n_split > 1:        # each split's o, then its (m, l), per row
        part = torch.empty(plan.n_split * b * hq * tq * (d + 2), dtype=torch.float32,
                           device=q.device)
    if k.dtype == torch.float32:        # the f32-K/V forms (the f32 cache's K3, a ring hop)
        status = build.library().zgml_flash_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _ptr(lse_t), _ptr(part), b,
            hq, hkv, tq, s, d, kv_len, int(q_offset), int(kv_row), plan.n_split, plan.bn,
            int(group is not None), 1.0 / d ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
        build.check(status, "flash_fwd_f32kv" if lse else "attention_f32kv")
        return o, lse_t
    status = build.library().zgml_flash_attention(
        q.data_ptr(), k.data_ptr(), _ptr(ks), v.data_ptr(), _ptr(vs), o.data_ptr(), _ptr(lse_t),
        _ptr(part), b, hq, hkv, tq, s, d, kv_len, int(q_offset), int(kv_row), plan.n_split,
        plan.bn, int(group is not None), 1.0 / d ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "flash_fwd" if lse else
                "attention" if ks is None else "flash_attention_q8")
    return o, lse_t


def decode_attention_cuda(q, k, v, kv_len, kv_row: int = 0):
    """Launch K4: over a bf16 cache, or in its f32 form over f32 k and v
    (counted under decode_attention_f32). kv_len: int32 CUDA tensor [B] (or
    an int, made into one)."""
    return _decode(q, k, None, v, None, kv_len, kv_row)


def decode_counter(k: torch.Tensor) -> str:
    """K4's placement counter for a cache of k's dtype: decode_attention
    over bf16, decode_attention_f32 over f32 (the f32 form)."""
    return "decode_attention_f32" if k.dtype == torch.float32 else "decode_attention"


def decode_per_sm(d: int, f32: bool) -> int:
    """K4's blocks an SM holds: two at head_dim <= 64 over bf16 (~85 KB of
    shared memory a block), at <= 32 in the f32 form (its tiles are twice
    as large: ~148 KB at 64), one above (csrc/decode_attn.cu dk_smem_bytes)."""
    return 2 if d <= (32 if f32 else 64) else 1


def decode_attention_q8_cuda(q, k, ks, v, vs, kv_len, kv_row: int = 0, i8pv: bool = False):
    """Launch K8 (q quantized per query head in the kernel; i8pv: its
    ZGML_TPU_ATTN_I8PV mode). kv_len: int32 CUDA tensor [B] (or an int, made
    into one)."""
    return _decode(q, k, ks, v, vs, kv_len, kv_row, i8pv)


def q8_counter(i8pv: bool) -> str:
    """K8's placement counter in its f32-p or its I8PV mode."""
    return "decode_attention_q8_i8pv" if i8pv else "decode_attention_q8"


def decode_q8_splits(b: int, hkv: int, s: int, d: int, sm_count: int, i8pv: bool) -> int:
    """K8's blocks per (batch row, KV head): K4's rule at two blocks an SM at
    every head dim (K8's shared memory stays under half an SM's: csrc/
    decode_attn.cu dq_stages), and in the I8PV mode no more than the cache
    has JAX blocks (a split takes whole blocks)."""
    unit = k8_block(s) if i8pv else decode_plan.DECODE_GROUP * decode_plan.DECODE_WARPS
    return decode_plan.decode_splits(b, hkv, s, d, sm_count, unit, per_sm=2)


def _decode(q, k, ks, v, vs, kv_len, kv_row, i8pv=False):
    name = decode_counter(k) if ks is None else q8_counter(i8pv)
    f32 = name == "decode_attention_f32"
    check_qkv(name, q, k, v, kv_row, 1, None if ks is None else (ks, vs),
              torch.float32 if f32 else torch.bfloat16)
    b, hq, _, d = q.shape
    _, hkv, s, _ = k.shape
    if not isinstance(kv_len, torch.Tensor):
        kv_len = torch.full((b,), int(kv_len), dtype=torch.int32, device=q.device)
    if (kv_len.device != q.device or kv_len.dtype != torch.int32
            or kv_len.shape != (b,) or not kv_len.is_contiguous()):
        raise ValueError(f"{name}: kv_len must be a contiguous int32 [{b}] tensor on {q.device}")
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    o = torch.empty_like(q)
    words = coop.counter_words(q.device, b * hkv).data_ptr()
    # one launch each, splits from the card's SM count
    if ks is None:            # K4, over bf16 or in its f32 form
        n_split = decode_plan.decode_splits(b, hkv, s, d, decode_plan.sm_count(index),
                                            per_sm=decode_per_sm(d, f32))
        part = torch.empty((b * hq, n_split, d + 2), dtype=torch.float32, device=q.device)
        launch = lib.zgml_decode_attention_f32 if f32 else lib.zgml_decode_attention_bf16
        status = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), o.data_ptr(),
            part.data_ptr(), words, b, hq, hkv, s, d, int(kv_row), n_split, 1.0 / d ** 0.5,
            stream)
    else:                     # K8
        n_split = decode_q8_splits(b, hkv, s, d, decode_plan.sm_count(index), i8pv)
        part = torch.empty((b * hq, n_split, d + 2), dtype=torch.float32, device=q.device)
        status = lib.zgml_decode_attention_q8(
            q.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(), vs.data_ptr(),
            kv_len.data_ptr(), o.data_ptr(), part.data_ptr(), words, b, hq, hkv, s, d,
            int(kv_row), n_split, k8_block(s), int(i8pv), 1.0 / d ** 0.5, stream)
    build.check(status, name)
    global_profile.count_op(name, "cuda")
    return o
