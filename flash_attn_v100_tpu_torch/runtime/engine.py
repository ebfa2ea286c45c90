"""Continuous-batching paged serving engine on one GPU.

Requests arrive with arbitrary prompts; the Scheduler (native C++ core,
csrc/fa_runtime.cpp, or its Python mirror) packs them into a fixed-width
decode batch under a paged KV budget, and every running sequence advances
one token per `step()`.

Design (the JAX package's engine, in eager PyTorch):
  * ONE page pool per K and V for all layers, with the LAYER axis folded
    into the page axis: (Hk, (num_pages + 1) * L, page_size, D), page p of
    layer l at folded id p * L + l.  Each layer addresses the pool through
    an offset block table (`tbl * L + l`) and its append writes in place.
    Quantized pools (kv_dtype int8, fp8 e4m3 or "int4", ops/quant.py) add
    (Hk, (num_pages + 1) * L, page_size, 1) fp32 scale pools; int4 pools
    hold page_size / 2 rows (two tokens a byte).
    Page 0 is a scratch page: padded batch rows point at it with
    cache_seqlens 0, so their appends land there and nobody reads them.
  * Bounded shapes: the decode batch is padded to `max_batch`, prefill
    prompts to power-of-two T buckets and power-of-two row buckets.
  * Prefill and decode share one model body (`paged_forward`): paged
    kvcache attention with fused rotary, causal.  Prefill rows with
    group * T >= VARLEN_PREFILL_MIN_ROWS (and page_size % 128 == 0) run the
    paged varlen kernel (K8), everything else the decode kernel (K4).
  * The decode loop does not wait for the device: sampled tokens stay on
    the device as lazy (tensor, index) entries, fetched in one transfer when
    a request finishes, re-prefills or is swept for EOS; a steady batch
    reuses its device block table, device cache_seqlens and sampling
    arrays, and `decode_fuse` runs up to n decode steps back to back with no
    host read between them.
  * Sharded serving (`mesh`, a parallel/mesh.py Mesh) runs SPMD: every rank
    of the mesh runs this engine with the same submit / step calls, holds
    its own parameter shards (models/transformer.py::shard_params) and its
    own pool shard, and takes the sampled tokens from the mesh's rank 0, so
    the ranks' schedulers cannot fork.  Heads and their pools split over
    "model" (tensor parallel: an all-reduce after the o-projection and
    after the MLP); with a "seq" axis > 1 the pools split too: block-table
    slot j is served by the pool of the seq rank that owns it (the
    scheduler's sharded allocator, ids shard-local, `num_pages` a shard),
    and attention runs parallel/sharded.py's sequence-sharded form (K4,
    never K8) with its LSE merge over "seq".
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from flash_attn_v100_tpu_torch.config import (
    DeviceLike, as_torch_dtype, resolve_device)
from flash_attn_v100_tpu_torch.models.transformer import (
    ModelConfig, logits_head, mlp, qkv_proj, rmsnorm, rope_tables)
from flash_attn_v100_tpu_torch.parallel.mesh import (
    MODEL_AXIS, SEQ_AXIS, Mesh, all_reduce, broadcast, local_shard)
from flash_attn_v100_tpu_torch.parallel.sharded import (
    flash_attn_with_kvcache_sharded)
from flash_attn_v100_tpu_torch.ops.kvcache import (
    flash_attn_with_kvcache, uses_varlen_route)
from flash_attn_v100_tpu_torch.ops.quant import FP8, is_int4, payload_bytes
from flash_attn_v100_tpu_torch.runtime.scheduler import Scheduler


def paged_forward(params, k_pool, v_pool, tokens, cache_seqlens, block_table,
                  cfg: ModelConfig, *, k_scales=None, v_scales=None,
                  mesh=None, rope=None, last_idx=None):
    """tokens (B, T) -> (logits (B, T, vocab) fp32, k_pool, v_pool
    [, k_scales, v_scales]).

    k_pool/v_pool: (Hk, P_f, ps, D) layer-folded HND pools (see the module
    docstring), appended IN PLACE and returned for the JAX call shape; with
    int8/fp8/int4 pools pass the (Hk, P_f, ps, 1) fp32 scale pools, which
    are updated in place and returned too.  block_table (B, max_pages)
    holds UNFOLDED page ids.  `rope` is an optional precomputed (cos, sin)
    on the pool's device; `last_idx` (B,) computes the logits at those
    positions only ((B, 1, vocab)).

    With `mesh` every rank of the mesh calls it with the same tokens, its
    shard_params slices and its pools' shards (its heads; with a "seq" axis
    > 1 also its pages, whose shard-local ids fill its columns of the
    global block table): attention runs on the local heads, through the
    sequence-sharded form when "seq" > 1, and the o-projection's and the
    MLP's partial sums are all-reduced over "model"."""
    quantized = k_scales is not None
    B, T = tokens.shape
    L = cfg.n_layers
    dev = tokens.device
    cos, sin = rope if rope is not None else rope_tables(
        cfg, cfg.max_seq_len, device=dev)
    page_size = (k_scales if quantized else k_pool).shape[2]
    seq_sharded = mesh is not None and mesh.shape[SEQ_AXIS] > 1
    _FORWARD_CALLS[_route(cfg, T, page_size, seq_sharded)] += 1
    kw = dict(rotary_cos=cos, rotary_sin=sin, causal=True,
              rotary_interleaved=False, window_size=cfg.window_size(),
              k_scales=k_scales, v_scales=v_scales)
    if seq_sharded:
        block_table = local_shard(block_table, (None, SEQ_AXIS), mesh)

    def reduce(y):   # the tensor-parallel partial sums, in y's dtype
        return y if mesh is None else all_reduce(y, mesh, MODEL_AXIS)
    x = params["embed"][tokens]
    for li, lp in enumerate(params["layers"]):
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = qkv_proj(h, lp, cfg, B, T)
        tbl = block_table * L + li       # folded page ids of this layer
        if seq_sharded:
            attn, _ = flash_attn_with_kvcache_sharded(
                q, k_pool, v_pool, mesh, cache_seqlens, k=k, v=v,
                block_table=tbl, **kw)
        else:
            attn, _ = flash_attn_with_kvcache(
                q, k_pool, v_pool, k=k, v=v, cache_seqlens=cache_seqlens,
                block_table=tbl, kv_cache_layout="HND", **kw)
        x = x + reduce(attn.reshape(B, T, -1) @ lp["wo"])
        x = x + reduce(mlp(rmsnorm(x, lp["ln2"], cfg.norm_eps), lp))
    if last_idx is not None:
        x = x[torch.arange(B, device=dev), last_idx.to(torch.long)][:, None]
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    logits = logits_head(x, params)
    if quantized:
        return logits, k_pool, v_pool, k_scales, v_scales
    return logits, k_pool, v_pool


# paged_forward calls per attention kernel route (a host-side count; each
# call launches one kernel of its route per layer)
_FORWARD_CALLS = {"decode": 0, "varlen": 0}
paged_forward.calls = _FORWARD_CALLS


def _route(cfg: ModelConfig, T: int, page_size: int,
           seq_sharded: bool = False) -> str:
    group = cfg.n_heads // cfg.n_kv_heads
    return "varlen" if not seq_sharded and uses_varlen_route(
        True, group, T, page_size) else "decode"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls.  temperature <= 0 means greedy;
    top_k == 0 means no top-k cut; top_p == 1.0 means no nucleus cut.  All
    three compose (top-k first, then top-p over the survivors)."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0


@dataclasses.dataclass
class _Sampling:
    """Per-row sampling arrays of one batch, on the device; `all_greedy`
    is known on the host, so an all-greedy batch runs only the argmax."""
    temp: torch.Tensor
    topk: torch.Tensor
    topp: torch.Tensor
    all_greedy: bool


def _sample_rows(logits: torch.Tensor, seed: int, s: _Sampling) -> torch.Tensor:
    """Per-row sampling of (B, V) fp32 logits on the device: rows with
    temp <= 0 take the argmax; others sample (Gumbel-max, from a
    torch.Generator seeded with `seed`) from the temperature-scaled
    distribution restricted to the top-k / top-p sets."""
    greedy_tok = logits.argmax(dim=-1).to(torch.int32)
    if s.all_greedy:
        return greedy_tok
    dev = logits.device
    V = logits.shape[-1]
    x = logits / s.temp.clamp(min=1e-6)[:, None]
    sort_idx = torch.argsort(-x, dim=-1)
    x_sorted = torch.gather(x, 1, sort_idx)
    probs = torch.softmax(x_sorted, dim=-1)
    ranks = torch.arange(V, device=dev)[None, :]
    keep = ranks < torch.where(s.topk[:, None] > 0, s.topk[:, None],
                               torch.full_like(s.topk[:, None], V))
    cum = torch.cumsum(probs, dim=-1)
    # nucleus: keep tokens until the cumulative probability first exceeds p
    keep &= (cum - probs) < s.topp[:, None]
    x_sorted = torch.where(keep, x_sorted, torch.full_like(x_sorted,
                                                           float("-inf")))
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand(x_sorted.shape, generator=gen, device=dev)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    samp = (x_sorted + gumbel).argmax(dim=-1, keepdim=True)
    sampled = torch.gather(sort_idx, 1, samp)[:, 0].to(torch.int32)
    return torch.where(s.temp <= 0.0, greedy_tok, sampled)


@dataclasses.dataclass
class _Seq:
    """`generated` entries are ints once materialized, or lazy
    (device_token_tensor, index) pairs — the engine never blocks the decode
    loop on a device->host fetch; values are pulled only when a sequence
    finishes, is re-prefilled after preemption, is swept for EOS, or
    `result()` is called."""
    id: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[Any] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done: bool = False
    sampling: Optional[SamplingParams] = None
    on_token: Optional[Any] = None    # callback(rid, new_tokens: List[int])
    streamed: int = 0                 # tokens already delivered to on_token
    # prefix cache: chain hashes of the prompt's FULL pages, and whether
    # this sequence's pages hold committed prefill KV
    page_hashes: List[int] = dataclasses.field(default_factory=list)
    prefilled: bool = False
    # chunked prefill: tokens already appended, the pages holding them, and
    # the step of the last chunk (a gap means preemption)
    prefill_committed: int = 0
    chunk_page_ids: List[int] = dataclasses.field(default_factory=list)
    last_chunk_step: int = -1


class ServingEngine:
    """Continuous-batching decode over one model replica on one device.

    >>> eng = ServingEngine(params, cfg, max_batch=8, num_pages=256)
    >>> rid = eng.submit([1, 2, 3], max_new_tokens=16)
    >>> while not eng.idle():
    ...     finished = eng.step()
    """

    def __init__(self, params, cfg: ModelConfig, *, max_batch: int = 8,
                 num_pages: int = 256, page_size: int = 16,
                 greedy: bool = True, temperature: float = 1.0,
                 rng_seed: int = 0, use_native: bool = True,
                 mesh=None, kv_dtype=None,
                 eos_token_id: Optional[int] = None,
                 eos_check_interval: int = 8,
                 prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None,
                 max_prefill_seqs: Optional[int] = None,
                 decode_fuse: int = 8,
                 device: DeviceLike = None):
        """Options as in the JAX package's ServingEngine.  `device` holds
        the pools and must hold `params` (default: CUDA).  `kv_dtype`:
        torch.int8, torch.float8_e4m3fn or "int4" (or their names) for a
        quantized pool (appended KV quantizes on the fly, the kernels
        dequantize in their tiles; "int4" packs two tokens a byte); any
        other `kv_dtype` than `cfg.dtype` raises TypeError (16/32-bit pools
        are read in the model dtype).  `mesh`: a parallel.mesh.Mesh this
        rank belongs to, for sharded serving (see the module docstring);
        `params` are then this rank's shard_params slices and `num_pages`
        counts a seq shard's pages."""
        sp = tp = 1
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                                f"{type(mesh).__name__}")
            if not mesh.is_member:
                raise ValueError(f"rank {mesh.rank} is not in the mesh")
            sp, tp = mesh.shape[SEQ_AXIS], mesh.shape[MODEL_AXIS]
            if cfg.n_kv_heads % tp:
                raise ValueError(f"{cfg.n_kv_heads} kv heads do not divide "
                                 f"the model axis ({tp})")
            want = cfg.n_heads // tp * cfg.head_dim
            if params["layers"][0]["wq"].shape[1] != want:
                raise ValueError("params must be this rank's shard_params "
                                 "slices")
        self.mesh = mesh
        self.seq_shards = sp
        self.kv_int4 = is_int4(kv_dtype)
        kv_dt = torch.int8 if self.kv_int4 else as_torch_dtype(
            kv_dtype or cfg.dtype)
        self.quantized = kv_dt in (torch.int8, FP8)
        if not self.quantized and kv_dt != as_torch_dtype(cfg.dtype):
            raise TypeError(f"kv_dtype {kv_dtype!r}: 16/32-bit pools are held "
                            f"in the model dtype {cfg.dtype}")
        if cfg.max_seq_len % page_size:
            raise ValueError("page_size must divide cfg.max_seq_len")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be positive")
        if max_prefill_seqs is not None and max_prefill_seqs < 1:
            raise ValueError("max_prefill_seqs must be positive")
        if decode_fuse < 1:
            raise ValueError("decode_fuse must be positive")
        self.device = resolve_device(device)
        self.prefill_chunk = prefill_chunk
        self.max_prefill_seqs = max_prefill_seqs
        self.params = params
        self.cfg = cfg
        self.page_size = page_size
        self.max_batch = max_batch
        self.max_pages_per_seq = cfg.max_seq_len // page_size
        if self.max_pages_per_seq % sp:
            raise ValueError(
                f"max_seq_len/page_size = {self.max_pages_per_seq} pages a "
                f"sequence must divide the seq axis ({sp})")
        # one scratch page (local id 0) backs inactive batch rows; the
        # scheduler hands out pages 1..num_pages (a shard's, with sp > 1:
        # slot j from the pool of seq rank j // slots_per_shard)
        self.sched = Scheduler(
            max_batch, num_pages, page_size, use_native=use_native,
            num_shards=sp, slots_per_shard=(self.max_pages_per_seq // sp
                                            if sp > 1 else 2**31 - 1))
        if self.kv_int4 and page_size % 2:
            raise ValueError("int4 pools pack two tokens a byte: page_size "
                             "must be even")
        # this rank's heads and (with sp > 1) its shard's pages
        pool_shape = (cfg.n_kv_heads // tp, (num_pages + 1) * cfg.n_layers,
                      page_size // 2 if self.kv_int4 else page_size,
                      cfg.head_dim)
        self.k_pool = torch.zeros(pool_shape, dtype=kv_dt, device=self.device)
        self.v_pool = torch.zeros(pool_shape, dtype=kv_dt, device=self.device)
        self.k_scales = self.v_scales = None
        if self.quantized:
            sc_shape = pool_shape[:2] + (page_size, 1)
            self.k_scales = torch.ones(sc_shape, dtype=torch.float32,
                                       device=self.device)
            self.v_scales = torch.ones(sc_shape, dtype=torch.float32,
                                       device=self.device)
        self._rope = rope_tables(cfg, cfg.max_seq_len, device=self.device)
        self.greedy = greedy
        self.temperature = temperature
        self.default_sampling = SamplingParams(
            temperature=0.0 if greedy else float(temperature))
        # sampling seeds: rng_seed and a host-side step counter
        self._rng_seed = int(rng_seed)
        self._rng_ctr = 0
        self._prev_tok = None               # last step's (max_batch,) tokens
        # the tensor lazy `generated` entries reference, and the index of a
        # row's LAST entry into it (None: 1D single-step tensor, entries
        # (t, row); int i: fused (n, max_batch) tensor, entries (t, (i, row)))
        self._prev_src = None
        self._prev_last: Optional[int] = None
        self.eos_token_id = eos_token_id
        self.eos_check_interval = max(1, eos_check_interval)
        # steady-state decode caches: (ids, page_counts, bt_dev, cs_dev,
        # sampling); device constants for the identity token gather
        self._steady = None
        self._id_gather = self._put(np.arange(max_batch, dtype=np.int64))
        self._all_dev = self._put(np.zeros((max_batch,), bool))
        self._zero_toks = self._put(np.zeros((max_batch,), np.int32))
        self._seqs: Dict[int, _Seq] = {}
        self._next_id = 0
        self.decode_fuse = decode_fuse
        self.prefix_cache = prefix_cache
        # chain hash -> (owner sid, n full pages covered)
        self._prefix_index: Dict[int, Tuple[int, int]] = {}
        self.metrics = dict(steps=0, tokens_generated=0, prefill_tokens=0,
                            prefix_hits=0, prefix_tokens_reused=0)

    # ---- device helpers ----

    def _put(self, x) -> torch.Tensor:
        """Host array -> device tensor; pinned and non-blocking on CUDA so
        the copy does not wait for the queued device work."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _seed(self, ctr: int) -> int:
        return (self._rng_seed * 1_000_003 + ctr) & 0x7FFF_FFFF_FFFF_FFFF

    def _forward(self, toks, cs, bt, last_idx=None):
        # the pools (and scales) are appended in place
        return paged_forward(
            self.params, self.k_pool, self.v_pool, toks, cs, bt, self.cfg,
            k_scales=self.k_scales, v_scales=self.v_scales, mesh=self.mesh,
            rope=self._rope, last_idx=last_idx)[0]

    def _sample(self, logits, ctr, sampling):
        """The next tokens; sharded, the mesh's rank 0's, so that a bit
        difference in a rank's logits cannot fork the schedulers."""
        tok = _sample_rows(logits[:, 0], self._seed(ctr), sampling)
        return tok if self.mesh is None else broadcast(tok, self.mesh)

    def _prefill_fn(self, toks, cs, bt, last_idx, ctr, sampling):
        logits = self._forward(toks, cs, bt, last_idx=last_idx)
        tok = self._sample(logits, ctr, sampling)
        # padded to the full batch width: the decode step gathers from it
        if tok.shape[0] < self.max_batch:
            tok = torch.cat([tok, tok.new_zeros(self.max_batch - tok.shape[0])])
        return tok

    def _decode_fn(self, prev_tok, gather_idx, use_host, host_toks, cs, bt,
                   ctr, sampling, n: int = 1):
        """n decode steps back to back, no host read between them; step i
        samples with counter ctr + i, so the stream equals n single steps.
        Returns (tokens (n, max_batch), last tokens, advanced cs)."""
        tok = torch.where(use_host, host_toks, prev_tok[gather_idx])
        out = []
        for i in range(n):
            logits = self._forward(tok[:, None], cs, bt)
            tok = self._sample(logits, ctr + i, sampling)
            cs = cs + 1
            out.append(tok)
        return torch.stack(out), tok, cs

    def _pool_ids(self, pages: List[int]) -> List[Optional[int]]:
        """A sequence's pages (slot j holds pages[j], a shard-local id with
        sp > 1) -> their ids in this rank's pool (+1: page 0 is the
        scratch page), None for a slot another seq rank's pool holds."""
        if self.seq_shards == 1:
            return [p + 1 for p in pages]
        spp = self.max_pages_per_seq // self.seq_shards
        mine = self.mesh.index(SEQ_AXIS)
        return [p + 1 if j // spp == mine else None
                for j, p in enumerate(pages)]

    def _copy_pages(self, src, dst):
        """Prefix-cache page copy on the layer-folded page axis: a page id
        expands to its L folded entries; padding entries are 0 -> 0
        (scratch to itself)."""
        L = self.cfg.n_layers
        ar = torch.arange(L, device=self.device)

        def fold(ids):
            return (ids.to(torch.long)[:, None] * L + ar).reshape(-1)
        src_f, dst_f = fold(src), fold(dst)
        pools = [self.k_pool, self.v_pool]
        if self.quantized:
            pools += [self.k_scales, self.v_scales]
        for pool in pools:
            pool = payload_bytes(pool)
            pool[:, dst_f] = pool[:, src_f]

    # ---- request API ----

    def submit(self, prompt: List[int], max_new_tokens: int = 64,
               sampling: Optional[SamplingParams] = None,
               on_token=None) -> int:
        """`sampling` overrides the engine default per request.  `on_token`
        is called as on_token(rid, new_tokens) whenever this request's
        tokens reach the host (EOS sweep, re-prefill, completion)."""
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.cfg.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        rid = self._next_id
        self._next_id += 1
        s = _Seq(rid, list(prompt), max_new_tokens,
                 submitted_at=time.monotonic(),
                 sampling=sampling, on_token=on_token)
        if self.prefix_cache:
            h, ps = 0, self.page_size
            for j in range(len(prompt) // ps):
                h = hash((h,) + tuple(prompt[j * ps:(j + 1) * ps]))
                s.page_hashes.append(h)
        self._seqs[rid] = s
        if not self.sched.add(rid, len(prompt), max_new_tokens):
            raise RuntimeError(f"scheduler refused request {rid}")
        return rid

    def idle(self) -> bool:
        st = self.sched.stats()
        return st["waiting"] == 0 and st["running"] == 0

    @staticmethod
    def _fetch(entries) -> Dict[int, np.ndarray]:
        """One device->host transfer per distinct token tensor."""
        uniq = {}
        for e in entries:
            if not isinstance(e, int):
                uniq.setdefault(id(e[0]), e[0])
        return {k: t.cpu().numpy() for k, t in uniq.items()}

    @staticmethod
    def _resolve(s: "_Seq", fetched) -> None:
        s.generated = [e if isinstance(e, int)
                       else int(fetched[id(e[0])][e[1]])
                       for e in s.generated]

    @classmethod
    def _materialize(cls, s: "_Seq") -> None:
        cls._resolve(s, cls._fetch(s.generated))
        if s.on_token is not None and len(s.generated) > s.streamed:
            new = s.generated[s.streamed:]
            s.streamed = len(s.generated)
            s.on_token(s.id, [int(t) for t in new])

    def result(self, rid: int) -> List[int]:
        s = self._seqs[rid]
        self._materialize(s)
        return list(s.generated)

    def ttft(self, rid: int) -> Optional[float]:
        s = self._seqs[rid]
        return None if s.first_token_at is None else (
            s.first_token_at - s.submitted_at)

    # ---- the decode loop body ----

    @staticmethod
    def _bucket(n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

    def _block_table(self, ids: List[int]) -> np.ndarray:
        bt = np.zeros((self.max_batch, self.max_pages_per_seq), np.int32)
        for row, sid in enumerate(ids):
            pages = self.sched.pages_of(sid)
            # +1: page 0 is the scratch page; scheduler ids are 0-based
            bt[row, :len(pages)] = np.asarray(pages, np.int32) + 1
        return bt

    def _next_ctrs(self, n: int) -> int:
        """Reserve n consecutive sampling counters; returns the first."""
        first = self._rng_ctr + 1
        self._rng_ctr += n
        return first

    def _sampling_arrays(self, ids: List[int],
                         rows: Optional[int] = None) -> _Sampling:
        """(temperature, top_k, top_p) per batch row, padded rows greedy."""
        rows = self.max_batch if rows is None else rows
        temp = np.zeros((rows,), np.float32)
        topk = np.zeros((rows,), np.int64)
        topp = np.ones((rows,), np.float32)
        for row, sid in enumerate(ids):
            sp = self._seqs[sid].sampling or self.default_sampling
            temp[row] = sp.temperature
            topk[row] = sp.top_k
            topp[row] = sp.top_p
        return _Sampling(self._put(temp), self._put(topk), self._put(topp),
                         bool(np.all(temp <= 0.0)))

    def step(self) -> List[int]:
        """Advance every running sequence one token.  Returns ids finished
        during this step."""
        batch = self.sched.step()
        if not batch:
            return []
        prefill = [sid for sid, pf in batch if pf]
        decode = [sid for sid, pf in batch if not pf]
        if self.max_prefill_seqs is not None and len(prefill) > 0:
            # staggered admission: chunk continuations keep priority (a
            # deferred continuation reads as preemption and restarts)
            cont = [s for s in prefill if self._seqs[s].prefill_committed]
            new = [s for s in prefill if not self._seqs[s].prefill_committed]
            keep = max(self.max_prefill_seqs, len(cont))
            prefill = (cont + new)[:keep]
        finished: List[int] = []
        if prefill:
            self._run_prefill(prefill, finished)
        if decode:
            self._run_decode(decode, finished)
        self.metrics["steps"] += 1
        for sid in finished:
            self._finish(sid)
        if (self.eos_token_id is not None
                and self.metrics["steps"] % self.eos_check_interval == 0):
            finished += self._reap_eos(batch)
        return finished

    def _finish(self, sid: int) -> None:
        self.sched.finish(sid)
        s = self._seqs[sid]
        s.done = True
        # freed pages must stop serving as prefix-copy sources
        for h in s.page_hashes:
            if self._prefix_index.get(h, (None, 0))[0] == sid:
                del self._prefix_index[h]

    def _reap_eos(self, batch) -> List[int]:
        """Periodic EOS sweep: one batched fetch of every pending token
        tensor, then finish sequences whose output contains the EOS
        (truncated exactly at it)."""
        running = [sid for sid, _ in batch if not self._seqs[sid].done]
        fetched = self._fetch([e for sid in running
                               for e in self._seqs[sid].generated])
        reaped = []
        for sid in running:
            s = self._seqs[sid]
            self._resolve(s, fetched)
            if s.on_token is not None and len(s.generated) > s.streamed:
                s.on_token(sid, [int(t) for t in s.generated[s.streamed:]])
                s.streamed = len(s.generated)
            if self.eos_token_id in s.generated:
                s.generated = s.generated[:s.generated.index(
                    self.eos_token_id) + 1]
                self._finish(sid)
                reaped.append(sid)
        if reaped:
            self._steady = None   # batch composition changes next step
        return reaped

    def run_to_completion(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        out = {}
        for _ in range(max_steps):
            if self.idle():
                break
            for sid in self.step():
                out[sid] = self.result(sid)
        return out

    def _prefix_lookup(self, sid: int, batch_ids) -> Tuple[List[int], int]:
        """Longest committed whole-page prompt prefix of `sid` held by a
        LIVE other sequence: (source page ids, n pages).  The hash only
        indexes — token equality is checked exactly; finished, preempted or
        same-batch sources are rejected."""
        s = self._seqs[sid]
        ps = self.page_size
        max_i = min(len(s.page_hashes), (len(s.prompt) - 1) // ps)
        for i in range(max_i, 0, -1):
            ent = self._prefix_index.get(s.page_hashes[i - 1])
            if not ent:
                continue
            src_id, n = ent
            if src_id == sid or src_id in batch_ids or n < i:
                continue
            src = self._seqs.get(src_id)
            if src is None or src.done or not src.prefilled:
                continue
            if src.prompt[:i * ps] != s.prompt[:i * ps]:
                continue
            src_pages = self.sched.pages_of(src_id)
            if len(src_pages) < i:
                continue
            return src_pages[:i], i
        return [], 0

    def _run_prefill(self, ids: List[int], finished: List[int]) -> None:
        # after preemption a sequence re-prefills prompt + emitted tokens
        # in one pass; re-prefill is where mid-generation token VALUES are
        # needed on the host
        for sid in ids:
            self._materialize(self._seqs[sid])
            self._seqs[sid].prefilled = False
        # a chunk continuation is valid only if the sequence was in the
        # previous step's batch and still holds the pages it chunked into
        step_no = self.metrics["steps"]
        for sid in ids:
            s = self._seqs[sid]
            if s.prefill_committed:
                k = len(s.chunk_page_ids)
                if (s.last_chunk_step != step_no - 1
                        or self.sched.pages_of(sid)[:k] != s.chunk_page_ids):
                    s.prefill_committed = 0
                    s.chunk_page_ids = []
        # prefix cache: rows whose prompt prefix is committed in a live
        # sequence's pages copy that KV and prefill only the suffix
        cached = {sid: 0 for sid in ids}
        if self.prefix_cache:
            batch_set = set(ids)
            src_idx, dst_idx = [], []
            for sid in ids:
                if self._seqs[sid].prefill_committed:
                    continue            # mid-chunk: prefix already handled
                src_pages, npg = self._prefix_lookup(sid, batch_set)
                if npg:
                    # source and destination cover the same slots, so each
                    # copy stays inside one seq rank's pool
                    dst_pages = self.sched.pages_of(sid)[:npg]
                    for a, b in zip(self._pool_ids(src_pages),
                                    self._pool_ids(dst_pages)):
                        if a is not None:
                            src_idx.append(a)
                            dst_idx.append(b)
                    cached[sid] = npg * self.page_size
                    self.metrics["prefix_hits"] += 1
                    self.metrics["prefix_tokens_reused"] += npg * self.page_size
            if src_idx:
                pad = self._bucket(len(src_idx)) - len(src_idx)
                self._copy_pages(
                    self._put(np.asarray(src_idx + [0] * pad, np.int64)),
                    self._put(np.asarray(dst_idx + [0] * pad, np.int64)))
        # spans: (sid, base, take, final) — this step appends tokens
        # [base, base + take) of prompt + generated; only final rows sample
        spans = []
        for sid in ids:
            s = self._seqs[sid]
            full_len = len(s.prompt) + len(s.generated)
            b = s.prefill_committed or cached[sid]
            rem = full_len - b
            take = rem if self.prefill_chunk is None else min(
                rem, self.prefill_chunk)
            spans.append((sid, b, take, take == rem))
        lens = [t for _, _, t, _ in spans]
        # T bucket, capped at max_seq_len so padded appends stay inside a
        # block-table row; power-of-two ROW bucket too
        T = min(self._bucket(max(lens)), self.cfg.max_seq_len)
        rb = 2
        while rb < len(ids):
            rb *= 2
        rb = min(rb, self.max_batch)
        toks = np.zeros((rb, T), np.int64)
        last_idx = np.zeros((rb,), np.int64)
        cs = np.zeros((rb,), np.int32)  # append position
        for row, (sid, b, take, _) in enumerate(spans):
            s = self._seqs[sid]
            toks[row, :take] = (s.prompt + s.generated)[b:b + take]
            last_idx[row] = take - 1   # sample at the last REAL position
            cs[row] = b
        sampling = self._sampling_arrays(ids, rows=rb)
        tok = self._prefill_fn(
            self._put(toks), self._put(cs),
            self._put(self._block_table(ids)[:rb]), self._put(last_idx),
            self._next_ctrs(1), sampling)
        self._emit(ids, tok, finished, first=True,
                   emit=[fin for _, _, _, fin in spans])
        self.metrics["prefill_tokens"] += int(sum(lens))
        ps = self.page_size
        for sid, b, take, fin in spans:
            s = self._seqs[sid]
            if fin:
                s.prefilled = True
                s.prefill_committed = 0
                s.chunk_page_ids = []
                for j, h in enumerate(s.page_hashes):
                    self._prefix_index[h] = (sid, j + 1)
            else:
                s.prefill_committed = b + take
                s.chunk_page_ids = self.sched.pages_of(sid)[
                    :-(-(b + take) // ps)]
                s.last_chunk_step = step_no
        # Rows were padded to the bucket: the padding's KV sits at positions
        # >= the real length and the next append of this sequence starts
        # exactly there, overwriting it; padded queries only see keys at or
        # before their own position (causal), so real logits are unaffected.

    def _run_decode(self, ids: List[int], finished: List[int]) -> None:
        # input tokens stay on the DEVICE: a row's last token is usually a
        # slot of the previous step's token tensor, gathered on the device;
        # rows whose last token lives in an older tensor take a host fetch
        prev = self._prev_tok
        ids_t = tuple(ids)
        counts = tuple(len(self.sched.pages_of(sid)) for sid in ids)
        st = self._steady
        li = self._prev_last
        steady = (st is not None and st[0] == ids_t and st[1] == counts
                  and prev is not None
                  and all(not isinstance(self._seqs[sid].generated[-1], int)
                          and self._seqs[sid].generated[-1][0]
                          is self._prev_src
                          and self._seqs[sid].generated[-1][1]
                          == (row if li is None else (li, row))
                          for row, sid in enumerate(ids)))
        n = 1
        if steady:
            # no host->device traffic: identity gather, cached block table,
            # device-advanced cs, cached sampling arrays
            bt_dev, cs_dev, sampling = st[2], st[3], st[4]
            gather_idx, use_host, host_toks = (
                self._id_gather, self._all_dev, self._zero_toks)
            # fused window: the largest power of two every row can run
            # without a host decision (page capacity and token budget)
            if self.decode_fuse > 1:
                lim = self.decode_fuse
                ps = self.page_size
                for row, sid in enumerate(ids):
                    s = self._seqs[sid]
                    cs_row = len(s.prompt) + len(s.generated) - 1
                    lim = min(lim, counts[row] * ps - cs_row,
                              s.max_new_tokens - len(s.generated))
                while n * 2 <= lim:
                    n *= 2
        else:
            cs = np.zeros((self.max_batch,), np.int32)
            gather_np = np.zeros((self.max_batch,), np.int64)
            usehost_np = np.ones((self.max_batch,), bool)
            hosttok_np = np.zeros((self.max_batch,), np.int32)
            for row, sid in enumerate(ids):
                s = self._seqs[sid]
                e = s.generated[-1]
                # a last token of the previous step is gatherable from
                # `prev` at its old row (for a fused window, prev is the
                # window's last row)
                old_row = None
                if not isinstance(e, int) and prev is not None \
                        and e[0] is self._prev_src:
                    old_row = (e[1] if li is None
                               else (e[1][1] if e[1][0] == li else None))
                if old_row is not None:
                    gather_np[row] = old_row
                    usehost_np[row] = False
                else:
                    hosttok_np[row] = (e if isinstance(e, int)
                                       else int(e[0][e[1]]))
                # KV covers prompt + all generated EXCEPT the last token,
                # which is this step's input, appended at this position
                cs[row] = len(s.prompt) + len(s.generated) - 1
            bt_dev = self._put(self._block_table(ids))
            cs_dev = self._put(cs)
            gather_idx = self._put(gather_np)
            use_host = self._put(usehost_np)
            host_toks = self._put(hosttok_np)
            sampling = self._sampling_arrays(ids)
        toks, last, cs_next = self._decode_fn(
            prev if prev is not None else self._zero_toks, gather_idx,
            use_host, host_toks, cs_dev, bt_dev, self._next_ctrs(n),
            sampling, n=n)
        if n > 1:
            self._emit_multi(ids, toks, last, n, finished)
        else:
            self._emit(ids, last, finished)
        # next step is steady if the batch stays identical and no sequence
        # crossed a page boundary (counts recomputed then)
        self._steady = (ids_t, counts, bt_dev, cs_next, sampling)

    def _emit(self, ids: List[int], tokens: torch.Tensor,
              finished: List[int], first: bool = False,
              emit: Optional[List[bool]] = None) -> None:
        """`emit[row]=False` (mid-chunk prefill rows): the sampled token is
        garbage by construction — nothing is recorded or counted."""
        self._prev_tok = tokens             # (max_batch,) device tensor
        self._prev_src = tokens
        self._prev_last = None
        stamp_rows = []
        for row, sid in enumerate(ids):
            if emit is not None and not emit[row]:
                continue
            s = self._seqs[sid]
            s.generated.append((tokens, row))   # lazy device token
            if first and s.first_token_at is None:
                stamp_rows.append(sid)
            self.metrics["tokens_generated"] += 1
            if self.sched.advance(sid):
                finished.append(sid)
        if stamp_rows:
            # TTFT is stamped once the token VALUE exists: wait for the
            # device, then read the clock (only first-token steps wait)
            if tokens.device.type == "cuda":
                torch.cuda.synchronize(tokens.device)
            now = time.monotonic()
            for sid in stamp_rows:
                self._seqs[sid].first_token_at = now

    def _emit_multi(self, ids: List[int], toks, last, n: int,
                    finished: List[int]) -> None:
        """Record a fused n-step window: `toks` is the (n, max_batch) token
        matrix, `last` its final row (the next step's gather source).  The
        window cap guarantees a row can finish only at the window end."""
        self._prev_tok = last
        self._prev_src = toks
        self._prev_last = n - 1
        for row, sid in enumerate(ids):
            s = self._seqs[sid]
            for i in range(n):
                s.generated.append((toks, (i, row)))
            self.metrics["tokens_generated"] += n
            for _ in range(n):
                if self.sched.advance(sid):
                    finished.append(sid)
