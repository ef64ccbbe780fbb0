"""Continuous-batching inference engine.

Beyond the reference (SURVEY.md §2.5): the reference ships a static-batch
decode loop (utils/generation.py); production serving needs slot-based
continuous batching — requests are admitted into
free KV-cache slots as others finish, with no global barrier between
sequences. The decode step is one jitted program over all slots; admission
runs a slot-mapped prefill that writes only the admitted slots' cache rows
(cache_batch_idx scatter). Per-slot lengths ride decode attention's per-batch
cache_seqlens.
"""

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from flash_attn_tpu.serving.generation import GenerationConfig, sample_token

__all__ = ["InferenceEngine", "PagePool", "Request"]


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray          # (prompt_len,) int32
    max_new_tokens: int = 64
    # filled by the engine:
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class PagePool:
    """Free-list page allocator for the paged KV cache (the vLLM-style
    memory manager the reference leaves to external engines).

    Page 0 is the NULL page (vLLM's null block) and is never allocated:
    every block-table entry that doesn't own a real page points there, so
    the writers that cannot be statically skipped — the decode step's
    appends for INACTIVE slots (the jitted step is one fixed-batch program)
    and any write past a slot's allocation — land in memory owned by
    nobody. Without this, table zeros alias whichever sequence happens to
    hold page 0 (a once-in-a-pool-lifetime corruption: the free list pops
    from the end, so page 0 is the last page handed out — exactly the
    fully-loaded case)."""

    def __init__(self, num_pages: int, page_size: int, max_pages_per_seq: int,
                 max_batch: int):
        self.page_size = page_size
        self.free = list(range(1, num_pages))  # page 0 = null page
        self.table = np.zeros((max_batch, max_pages_per_seq), np.int32)
        self.pages_of: Dict[int, List[int]] = {}
        # Prefix-caching support (round 5): shared pages are refcounted;
        # pages whose refcount drops to zero but that back a registered
        # prefix are RETAINED (insertion-ordered dict = LRU) instead of
        # freed, and reclaimed lazily under pool pressure via evict_cb
        # (the engine purges its hash index) — vLLM's prefix-cache
        # retention semantics.
        self.rc: Dict[int, int] = {}
        self.retained: Dict[int, None] = {}
        self.protected: set = set()   # pages backing prefix-index entries
        self.evict_cb = None          # called with the page id on eviction

    def _take_free(self):
        if self.free:
            return self.free.pop()
        if self.retained:
            pg = next(iter(self.retained))
            del self.retained[pg]
            self.protected.discard(pg)
            if self.evict_cb is not None:
                self.evict_cb(pg)
            return pg
        return None

    def alloc(self, slot: int, tokens_needed: int) -> bool:
        """Ensure slot has pages covering tokens_needed; False if OOM."""
        have = len(self.pages_of.get(slot, []))
        need = -(-tokens_needed // self.page_size)
        if need > self.table.shape[1]:
            return False
        while have < need:
            pg = self._take_free()
            if pg is None:
                return False
            self.rc[pg] = 1
            self.pages_of.setdefault(slot, []).append(pg)
            self.table[slot, have] = pg
            have += 1
        return True

    def share(self, slot: int, pages: List[int]):
        """Attach already-resident pages (a cached prefix) to a fresh
        slot: refcount++, revive retained pages. Must precede alloc()."""
        assert not self.pages_of.get(slot)
        for i, pg in enumerate(pages):
            if pg in self.retained:
                del self.retained[pg]
            self.rc[pg] = self.rc.get(pg, 0) + 1
            self.pages_of.setdefault(slot, []).append(pg)
            self.table[slot, i] = pg

    def release(self, slot: int):
        for pg in self.pages_of.pop(slot, []):
            self.rc[pg] = self.rc.get(pg, 1) - 1
            if self.rc[pg] > 0:
                continue
            del self.rc[pg]
            if pg in self.protected:
                self.retained[pg] = None   # keep warm for prefix reuse
            else:
                self.free.append(pg)
        self.table[slot, :] = 0  # back to the null page


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


class InferenceEngine:
    def __init__(self, model, params, max_batch: int, gen_cfg: GenerationConfig,
                 rng: Optional[jax.Array] = None,
                 page_pool: Optional[PagePool] = None,
                 max_admit_tokens: Optional[int] = None,
                 bucket_admission: bool = True,
                 decode_block_size: int = 1,
                 prefix_cache: bool = False,
                 draft_model=None, draft_params=None,
                 speculative_k: int = 4):
        self.model = model
        self.params = params
        self.B = max_batch
        self.cfg = gen_cfg
        self.rng = rng if rng is not None else jax.random.PRNGKey(0)
        self.pool = page_pool
        # Admission token budget: caps rows*max_prompt_len per prefill call
        # so admission activation memory stays bounded at large slot counts
        # (the chunked-prefill half of vLLM-style scheduling; leftover
        # requests are admitted on subsequent steps between decode steps).
        self.max_admit_tokens = max_admit_tokens
        # Shape-bucketed admission (the reference buckets its CUDA decode
        # graphs per batch size, utils/generation.py:618 — here the retrace
        # unit is the jitted prefill, keyed on (rows, padded_len)): rows pad
        # to the next power of two using still-free slots as zero-length
        # dummies, prompt length pads to the next power of two. Distinct
        # compiled prefill shapes are then <= log2(B) * log2(max_prompt),
        # not one per novel (rows, length) pair. prefill_shapes records the
        # shapes actually compiled (observability + the bound's test).
        self.bucket_admission = bucket_admission
        self.prefill_shapes: set = set()
        # Decode in blocks of n steps per host round-trip (multi-step
        # scheduling): one jitted lax.scan samples n tokens on device before
        # the engine fetches them. On a dispatch/fetch-latency-bound link
        # (~10-30 ms per fetch vs ~19 ms/step for the 913M model) this
        # amortizes the sync; requests that finish mid-block waste their
        # tail steps (bounded by n-1) and page release defers to the block
        # edge — PagePool allocations add the n-1 margin below.
        self.decode_block = max(1, decode_block_size)

        self.queue: deque = deque()
        self.requests: Dict[int, Request] = {}
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.slot_tok = np.zeros((max_batch,), np.int32)
        self.slot_new = np.zeros((max_batch,), np.int32)  # generated count
        self._next_id = 0
        self.cache = None
        # Async host pipeline: the decode block dispatched at step k is
        # NOT fetched until step k+1 has dispatched block k+1 — the device
        # carries the token feedback (ys[-1]), so the host fetch overlaps
        # the next block's compute instead of gating it.
        # _pending = (ys_device, slot->request snapshot at dispatch).
        self._pending: Optional[Tuple[jax.Array, List[Optional[Request]]]] \
            = None
        self._table_dev = None  # device copy of pool.table (see _table)
        # Speculative decoding inside the engine (round 5; the reference's
        # decode_speculative is a standalone static-batch loop —
        # utils/generation.py:269): when a draft model is given, each
        # decode step becomes one speculative ROUND (draft proposes k,
        # target verifies k+1 in one call, per-slot acceptance + cache
        # rewinds), losslessly equivalent to plain decoding per the
        # probability-ratio test (exact for greedy).
        self.spec = draft_model is not None
        self.speculative_k = speculative_k
        self.draft_model = draft_model
        self.draft_params = draft_params
        self.draft_cache = None
        self.slot_prev2 = np.zeros((max_batch,), np.int32)
        # Prefix caching (round 5, beyond the reference — vLLM automatic
        # prefix caching): FULL prompt pages are chain-hashed and shared
        # across requests; admission reuses the longest cached run of
        # pages (refcounted; retained after release until pool pressure)
        # and prefills only the suffix, attending the whole cache through
        # the packed paged-varlen kernel (MHA prefix_lengths path).
        self.prefix_cache = prefix_cache
        if self.spec:
            assert not prefix_cache, \
                "speculative x prefix_cache unsupported (the draft cache " \
                "holds no shared pages)"
        if prefix_cache:
            assert page_pool is not None, "prefix_cache needs a page pool"
            self._prefix_index: Dict[bytes, int] = {}
            self._page_keys: Dict[int, bytes] = {}
            self.prefix_hit_pages = 0

            def _evict(pg):
                key = self._page_keys.pop(pg, None)
                if key is not None and self._prefix_index.get(key) == pg:
                    del self._prefix_index[key]

            page_pool.evict_cb = _evict

        # The jitted step closures capture LOCALS, never `self`: a closure
        # over `self` creates a reference cycle (self -> jitted fn -> cell ->
        # self) that defers the engine's multi-GB cache to the cycle GC —
        # measured round-5: two sequential engines at the 913M bench shape
        # OOM the 16 GB chip because the first cache (6 GB) is still alive
        # when the second allocates.
        model, gen_cfg, n_block = self.model, self.cfg, self.decode_block

        # Donate the cache: the per-layer KV scatter otherwise forces XLA to
        # materialize a full cache copy per step (measured: the copies, not
        # the math, dominated 1B-model decode).
        def _decode_block_fn(params, cache, toks, rng, block_table):
            kw = {} if block_table is None else {"block_table": block_table}

            def body(carry, _):
                cache, toks, rng = carry
                logits, state = model.apply(
                    {"params": params, "cache": cache}, toks[:, None],
                    mode="decode", mutable=["cache"], **kw)
                rng, key = jax.random.split(rng)
                nxt = sample_token(logits[:, -1], key, gen_cfg)
                return (state["cache"], nxt, rng), nxt

            (cache, _, rng), ys = jax.lax.scan(
                body, (cache, toks, rng), None, length=n_block)
            return ys, cache, rng  # ys: (n, B)

        self._decode_block_fn = jax.jit(_decode_block_fn, donate_argnums=(1,))

        def _prefill(params, cache, ids, slot_ids, lengths, rng, block_table,
                     prefixes=None):
            variables = {"params": params}
            if cache is not None:
                variables["cache"] = cache
            kw = {} if block_table is None else {"block_table": block_table}
            if prefixes is not None:
                # prefix-cached chunked prefill: ids carry only the suffix
                kw["prefix_lengths"] = prefixes
            # lm_head runs only at each prompt's true last position (full
            # (b, s, vocab) fp32 logits OOM at serving batch sizes)
            logits, state = model.apply(
                variables, ids, mode="prefill", mutable=["cache"],
                slot_ids=slot_ids, prefill_lengths=lengths,
                logits_positions=lengths - 1, **kw)
            rng, key = jax.random.split(rng)
            nxt = sample_token(logits[:, 0], key, gen_cfg)
            return nxt, state["cache"], rng

        self._prefill = jax.jit(_prefill, donate_argnums=(1,))

        if self.spec:
            from flash_attn_tpu.serving.speculative import (
                _rewind_cache, sample_speculative)

            dmodel, kspec = draft_model, speculative_k

            def _draft_prefill(d_params, d_cache, ids, slot_ids, lengths):
                variables = {"params": d_params}
                if d_cache is not None:
                    variables["cache"] = d_cache
                _, state = dmodel.apply(
                    variables, ids, mode="prefill", mutable=["cache"],
                    slot_ids=slot_ids, prefill_lengths=lengths,
                    logits_positions=jnp.maximum(lengths - 1, 0))
                return state["cache"]

            self._draft_prefill = jax.jit(_draft_prefill,
                                          donate_argnums=(1,))

            def _spec_round(t_params, d_params, t_cache, d_cache, cur,
                            prev2, active, rng, t_table):
                # draft proposes k tokens from the SAME filtered
                # distribution the acceptance test uses
                feed = jnp.stack([prev2, cur], axis=1)  # (B, 2)
                proposals, d_logits_list = [], []
                for _step in range(kspec):
                    dl, d_state = dmodel.apply(
                        {"params": d_params, "cache": d_cache}, feed,
                        mode="decode", mutable=["cache"])
                    d_cache = d_state["cache"]
                    rng, dkey = jax.random.split(rng)
                    nxt = sample_token(dl[:, -1], dkey, gen_cfg)
                    proposals.append(nxt)
                    d_logits_list.append(dl[:, -1])
                    feed = nxt[:, None]
                tokens_draft = jnp.stack(proposals, axis=1)      # (B, k)
                logits_draft = jnp.stack(d_logits_list, axis=1)
                toks = jnp.concatenate([cur[:, None], tokens_draft], 1)
                kw = {} if t_table is None else {"block_table": t_table}
                tl, t_state = model.apply(
                    {"params": t_params, "cache": t_cache}, toks,
                    mode="decode", mutable=["cache"], **kw)
                t_cache = t_state["cache"]
                rng, key = jax.random.split(rng)
                tokens, num = sample_speculative(
                    tl, logits_draft, tokens_draft, key,
                    top_k=gen_cfg.top_k, top_p=gen_cfg.top_p,
                    temperature=gen_cfg.temperature, min_p=gen_cfg.min_p)
                # rewinds: active rows keep n_acc+1 of the k+1 target
                # appends and return the draft to committed'[:-2]; rows
                # inactive at dispatch rewind everything they appended
                n_acc = num - 1
                delta = jnp.where(active, kspec - n_acc, kspec + 1)
                t_cache = _rewind_cache(t_cache, delta)
                d_cache = _rewind_cache(d_cache, delta)
                return tokens, num, t_cache, d_cache, rng

            self._spec_round = jax.jit(_spec_round, donate_argnums=(2, 3))

    # ------------------------------------------------------------------
    def _prefix_keys(self, prompt: np.ndarray):
        """Chain hash per FULL prompt page (key_i commits to pages 0..i)."""
        import hashlib

        ps = self.pool.page_size
        keys = []
        key = b""
        for i in range(len(prompt) // ps):
            h = hashlib.sha1(key)
            h.update(np.ascontiguousarray(
                prompt[i * ps:(i + 1) * ps], dtype=np.int32).tobytes())
            key = h.digest()
            keys.append(key)
        return keys

    def _match_prefix(self, keys):
        """Longest cached run of pages for this chain (resident or
        retained)."""
        pages = []
        for key in keys:
            pg = self._prefix_index.get(key)
            if pg is None:
                break
            pages.append(pg)
        return pages

    def _register_prefix(self, slot, keys):
        for i, key in enumerate(keys):
            pg = self.pool.pages_of[slot][i]
            if key not in self._prefix_index:
                self._prefix_index[key] = pg
                self._page_keys[pg] = key
                self.pool.protected.add(pg)

    # ------------------------------------------------------------------
    def warmup(self, prefill_shapes=None):
        """Pre-compile + pre-execute the jitted programs before traffic —
        the analogue of the reference pre-capturing its decode CUDA
        graphs per batch size (utils/generation.py:618 update_graph_cache /
        :693 capture_graph). Without this, every bucketed prefill shape
        compiles on the request path (~30-60 s each on first sight).

        ``prefill_shapes``: iterable of (rows, padded_len) admission shapes
        to pre-build. Default: the single full-budget shape the admission
        bucketing produces under ``max_admit_tokens`` (rows = budget /
        max_decode_seqlen rounded to pow2) — callers with a known traffic
        mix should pass their shapes explicitly. The dummy prefill runs
        with lengths=0 on free slots, so it writes nothing and leaves
        engine state untouched (offsets re-zeroed afterwards).
        """
        if self.cache is None:
            self._init_cache()
        if prefill_shapes is None:
            cap = getattr(getattr(self.model, "config", None),
                          "max_decode_seqlen", 0) or 512
            plen = _next_pow2(max(16, cap - self.decode_block - 16))
            rows = self.B
            if self.max_admit_tokens is not None:
                rows = max(1, self.max_admit_tokens // plen)
            rows = min(_next_pow2(rows), self.B)
            prefill_shapes = [(rows, plen)]
        for rows, plen in prefill_shapes:
            ids = np.zeros((rows, plen), np.int32)
            slot_ids = np.arange(rows, dtype=np.int32)
            lengths = np.zeros((rows,), np.int32)
            _, self.cache, self.rng = self._prefill(
                self.params, self.cache, jnp.asarray(ids),
                jnp.asarray(slot_ids), jnp.asarray(lengths), self.rng,
                self._table())
            self.prefill_shapes.add((rows, plen))
        # decode program (appends land on inactive slots: the null page /
        # position 0, both overwritten by any real admission)
        _, self.cache, self.rng = self._decode_block_fn(
            self.params, self.cache, jnp.asarray(self.slot_tok),
            self.rng, self._table())
        self._set_inactive_offsets_zero()

    def reset(self):
        """Clear all requests/slots but KEEP the cache arrays and compiled
        programs — reuse one engine across benchmark passes instead of
        paying a second multi-GB cache + full recompile."""
        if self.pool is not None:
            for slot in list(self.pool.pages_of):
                self.pool.release(slot)
            self._table_dev = None
        self.queue.clear()
        self.requests.clear()
        self._pending = None
        self.slots = [None] * self.B
        self.slot_tok[:] = 0
        self.slot_new[:] = 0
        if self.cache is not None:
            self._set_inactive_offsets_zero()

    def close(self):
        """Release the KV cache and compiled-step references eagerly."""
        self.cache = None
        self.draft_cache = None
        self._prefill = self._decode_block_fn = None
        self.reset()

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 64) -> int:
        req = Request(self._next_id, np.asarray(prompt, np.int32),
                      max_new_tokens)
        self._next_id += 1
        self.queue.append(req)
        self.requests[req.req_id] = req
        return req.req_id

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def _offsets(self) -> np.ndarray:
        for path, leaf in jax.tree_util.tree_flatten_with_path(self.cache)[0]:
            if getattr(path[-1], "key", None) == "offset":
                return np.asarray(leaf)
        raise ValueError

    def _set_inactive_offsets_zero(self):
        active = np.array([r is not None for r in self.slots])

        def fix(path, leaf):
            if getattr(path[-1], "key", None) == "offset":
                return jnp.where(jnp.asarray(active), leaf, 0)
            return leaf

        self.cache = jax.tree_util.tree_map_with_path(fix, self.cache)
        if self.draft_cache is not None:
            self.draft_cache = jax.tree_util.tree_map_with_path(
                fix, self.draft_cache)

    def _table(self):
        # device table cached between admission/release events: a fresh
        # jnp.asarray per step costs a host->device upload on the decode
        # critical path
        if self.pool is None:
            return None
        if self._table_dev is None:
            self._table_dev = jnp.asarray(self.pool.table)
        return self._table_dev

    def _init_cache(self):
        # allocate the cache collection by running a B-batch prefill of
        # zero-length rows (jitted: op-by-op it compiles every op alone)
        ids = jnp.zeros((self.B, 8), jnp.int32)
        kw = {}
        if self.pool is not None:
            kw["block_table"] = jnp.asarray(self.pool.table)
        model, B = self.model, self.B
        _, state = jax.jit(lambda params: model.apply(
            {"params": params}, ids, mode="prefill", mutable=["cache"],
            slot_ids=jnp.arange(B),
            prefill_lengths=jnp.zeros((B,), jnp.int32), **kw))(self.params)
        self.cache = state["cache"]
        if self.spec:
            _, dstate = self.draft_model.apply(
                {"params": self.draft_params}, ids, mode="prefill",
                mutable=["cache"], slot_ids=jnp.arange(self.B),
                prefill_lengths=jnp.zeros((self.B,), jnp.int32))
            self.draft_cache = dstate["cache"]
        self._set_inactive_offsets_zero()

    # ------------------------------------------------------------------
    def step(self) -> List[Tuple[int, int]]:
        """One engine step: admit queued requests into free slots (prefill),
        dispatch one decode block for all active slots, then process the
        PREVIOUS step's block (async host pipeline: the fetch of block k's
        tokens overlaps block k+1's device compute — the device carries the
        token feedback, so the host roundtrip is off the critical path).
        Returns the list of (req_id, token) emitted this step; decode
        tokens lag dispatch by one step."""
        if self.cache is None:
            self._init_cache()
        emitted: List[Tuple[int, int]] = []

        # ---- admission ----
        free = self._free_slots()
        # admit tuples: (slot, request, shared_prefix_tokens, chain_keys)
        admit: List[Tuple[int, Request, int, list]] = []
        # in-batch sharing (parallel sampling: N same-prompt requests in
        # one admission): chain keys of already-admitted rows resolve to
        # their freshly-allocated pages. Safe within one prefill call —
        # every row's KV write completes before any row's attention reads
        # (the attention kernel depends on the updated cache arrays).
        batch_keys: Dict[bytes, int] = {}
        while free and self.queue:
            req = self.queue[0]
            slot = free[0]
            keys: list = []
            shared_pages: List[int] = []
            if self.prefix_cache:
                keys = self._prefix_keys(req.prompt)
                shared_pages = self._match_prefix(keys)
                if len(shared_pages) < len(keys):
                    for key in keys[len(shared_pages):]:
                        pg = batch_keys.get(key)
                        if pg is None:
                            break
                        shared_pages.append(pg)
                # never share ALL the prompt's pages when the prompt is
                # page-aligned: the suffix must be >= 1 token so the
                # prefill emits this request's first logits
                max_share = (len(req.prompt) - 1) // self.pool.page_size
                shared_pages = shared_pages[:max_share]
            n_shared = len(shared_pages) * (self.pool.page_size
                                            if self.pool else 0)
            suffix = len(req.prompt) - n_shared
            if self.max_admit_tokens is not None and admit:
                # Padded prefill cost is rows * max_len; admit the request
                # only if the padded batch stays within the token budget.
                max_len = max(suffix,
                              max(len(r.prompt) - ns
                                  for _, r, ns, _k in admit))
                if self.bucket_admission:
                    max_len = _next_pow2(max(max_len, 16))
                if (len(admit) + 1) * max_len > self.max_admit_tokens:
                    break  # admit the rest next step
            if self.pool is not None:
                margin = (self.speculative_k + 1 if self.spec
                          else 2 * self.decode_block - 1)
                if shared_pages:
                    self.pool.share(slot, shared_pages)
                    self.prefix_hit_pages += len(shared_pages)
                if not self.pool.alloc(
                        slot, len(req.prompt) + req.max_new_tokens
                        + margin):
                    self.pool.release(slot)
                    break  # out of pages: wait for completions
            free.pop(0)
            self.queue.popleft()
            admit.append((slot, req, n_shared, keys))
            self._table_dev = None
            if self.prefix_cache:
                pages = self.pool.pages_of.get(slot, [])
                for i, key in enumerate(keys):
                    if i < len(pages):
                        batch_keys.setdefault(key, pages[i])
        if admit:
            rows = len(admit)
            max_len = max(len(r.prompt) - ns for _, r, ns, _k in admit)
            dummies: List[int] = []
            if self.bucket_admission:
                # bucket the jitted-prefill shape: rows -> next pow2 (padding
                # rows are zero-length dummies on still-free slots — they
                # write nothing: new_lengths masks the paged scatter and the
                # slot's offset stays 0), length -> next pow2 (>=16)
                want = _next_pow2(rows)
                dummies = free[:want - rows]
                pad_len = _next_pow2(max(max_len, 16))
                # never pad past the model's rotary/cache allocation length
                cap = getattr(getattr(self.model, "config", None),
                              "max_decode_seqlen", 0)
                if cap:
                    pad_len = min(pad_len, max(cap, max_len))
                max_len = pad_len
            rows_p = rows + len(dummies)
            ids = np.zeros((rows_p, max_len), np.int32)
            lengths = np.zeros((rows_p,), np.int32)
            prefixes = np.zeros((rows_p,), np.int32)
            slot_ids = np.asarray(
                [s for s, _r, _n, _k in admit] + dummies, np.int32)
            for j, (slot, req, n_shared, _keys) in enumerate(admit):
                suffix = req.prompt[n_shared:]
                ids[j, :len(suffix)] = suffix
                lengths[j] = len(suffix)
                prefixes[j] = n_shared
                self.slots[slot] = req
                self.slot_new[slot] = 0
            self.prefill_shapes.add((rows_p, max_len))
            nxt, self.cache, self.rng = self._prefill(
                self.params, self.cache, jnp.asarray(ids),
                jnp.asarray(slot_ids), jnp.asarray(lengths), self.rng,
                self._table(),
                jnp.asarray(prefixes) if self.prefix_cache else None)
            if self.prefix_cache:
                # register this batch's FULL prompt pages for future reuse
                for slot, req, _n, keys in admit:
                    self._register_prefix(slot, keys)
            if self.spec:
                # draft-cache convention (serving/speculative.py): holds
                # KV for committed[:-2] = prompt[:-1] after admission
                self.draft_cache = self._draft_prefill(
                    self.draft_params, self.draft_cache, jnp.asarray(ids),
                    jnp.asarray(slot_ids),
                    jnp.maximum(jnp.asarray(lengths) - 1, 0))
                for slot, req, _n, _k in admit:
                    self.slot_prev2[slot] = int(req.prompt[-1])
            nxt = np.asarray(nxt)
            for j, (slot, req, _n, _keys) in enumerate(admit):
                tok = int(nxt[j])
                req.generated.append(tok)
                self.slot_tok[slot] = tok
                self.slot_new[slot] = 1
                emitted.append((req.req_id, tok))
                self._maybe_finish(slot, req, tok)

        # ---- speculative mode: one synchronous round per step ----
        if self.spec:
            if any(r is not None for r in self.slots):
                active = np.array([r is not None for r in self.slots])
                tokens, num, self.cache, self.draft_cache, self.rng = \
                    self._spec_round(
                        self.params, self.draft_params, self.cache,
                        self.draft_cache, jnp.asarray(self.slot_tok),
                        jnp.asarray(self.slot_prev2), jnp.asarray(active),
                        self.rng, self._table())
                tokens_np = np.asarray(tokens)
                num_np = np.asarray(num)
                finished: List[int] = []
                for slot, req in enumerate(self.slots):
                    if req is None:
                        continue
                    for tok in tokens_np[slot, :int(num_np[slot])]:
                        if req.done:
                            break  # tail past eos/max discarded
                        tok = int(tok)
                        req.generated.append(tok)
                        self.slot_prev2[slot] = self.slot_tok[slot]
                        self.slot_tok[slot] = tok
                        self.slot_new[slot] += 1
                        emitted.append((req.req_id, tok))
                        self._maybe_finish(slot, req, tok, defer=finished)
                if finished:
                    for slot in finished:
                        self.slots[slot] = None
                        if self.pool is not None:
                            self.pool.release(slot)
                            self._table_dev = None
                    self._set_inactive_offsets_zero()
            return emitted

        # ---- dispatch this step's decode block BEFORE fetching the
        # previous one (async host pipeline): the device carries the token
        # feedback (block k's ys[-1] feeds block k+1 without a roundtrip),
        # newly admitted slots' prefill tokens are merged in by scatter ----
        new_pending = None
        if any(r is not None for r in self.slots):
            if self._pending is None:
                toks = jnp.asarray(self.slot_tok)
            else:
                toks = self._pending[0][-1]
                if admit:
                    idx = np.asarray([s for s, _r, _n, _k in admit], np.int32)
                    toks = toks.at[jnp.asarray(idx)].set(
                        jnp.asarray(self.slot_tok[idx]))
            ys, self.cache, self.rng = self._decode_block_fn(
                self.params, self.cache, toks, self.rng, self._table())
            # start the device->host copy NOW: it fires as soon as the
            # block completes, so next step's np.asarray finds the tokens
            # already on the host instead of paying the fetch roundtrip
            try:
                ys.copy_to_host_async()
            except AttributeError:  # non-jax array backends
                pass
            new_pending = (ys, list(self.slots))

        # ---- process the PREVIOUS block: its fetch overlaps the block
        # dispatched above. Token attribution uses the slot->request
        # snapshot taken at ITS dispatch (a slot may since have finished
        # and been re-admitted). A request that finishes mid-stream keeps
        # decoding until the next dispatch sees it gone — tail tokens are
        # discarded and the admission allocation reserves a 2n-1 page
        # margin for the (mid-block waste + one stale block) worst case.
        if self._pending is not None:
            ys_dev, snap = self._pending
            ys = np.asarray(ys_dev)  # (n, B)
            finished: List[int] = []
            for t in range(ys.shape[0]):
                for slot, req in enumerate(snap):
                    if req is None or req.done or self.slots[slot] is not req:
                        continue
                    tok = int(ys[t, slot])
                    req.generated.append(tok)
                    self.slot_tok[slot] = tok
                    self.slot_new[slot] += 1
                    emitted.append((req.req_id, tok))
                    self._maybe_finish(slot, req, tok, defer=finished)
            if finished:
                for slot in finished:
                    self.slots[slot] = None
                    if self.pool is not None:
                        self.pool.release(slot)
                        self._table_dev = None
                # offsets of freed slots reset before any reuse; skipping
                # this on finish-free steps keeps the ~16 tiny per-leaf
                # dispatches off the steady-state decode path
                self._set_inactive_offsets_zero()
        self._pending = new_pending
        return emitted

    def _maybe_finish(self, slot: int, req: "Request", tok: int, defer=None):
        eos = self.cfg.eos_token_id
        if (eos is not None and tok == eos) or (
                self.slot_new[slot] >= req.max_new_tokens):
            req.done = True
            if defer is not None:
                defer.append(slot)
                return
            self.slots[slot] = None
            if self.pool is not None:
                self.pool.release(slot)
                self._table_dev = None

    def cancel(self, req_id: int) -> bool:
        """Cancel a request: drop it from the queue, or mark its slot for
        release (freed when the in-flight block is processed; any tokens
        decoded meanwhile are discarded like a post-eos tail). Returns
        False for unknown/finished ids."""
        req = self.requests.get(req_id)
        if req is None or req.done:
            return False
        req.done = True  # processing skips done requests
        for i, qreq in enumerate(self.queue):
            if qreq.req_id == req_id:
                del self.queue[i]
                return True
        for slot, sreq in enumerate(self.slots):
            if sreq is req:
                self.slots[slot] = None
                if self.pool is not None:
                    self.pool.release(slot)
                    self._table_dev = None
                self._set_inactive_offsets_zero()
                break
        return True

    def stats(self) -> Dict[str, object]:
        """Engine observability snapshot (the reference exposes nothing
        comparable; vLLM's /metrics analogue): slot/pool occupancy,
        compiled prefill shapes, prefix-cache hit count."""
        out: Dict[str, object] = {
            "active_slots": sum(s is not None for s in self.slots),
            "max_batch": self.B,
            "queued": len(self.queue),
            "prefill_shapes": sorted(self.prefill_shapes),
            "pending_block": self._pending is not None,
        }
        if self.pool is not None:
            out.update(
                pool_free_pages=len(self.pool.free),
                pool_retained_pages=len(self.pool.retained),
                pool_active_pages=len(self.pool.rc),
            )
        if self.prefix_cache:
            out.update(prefix_hit_pages=self.prefix_hit_pages,
                       prefix_index_entries=len(self._prefix_index))
        return out

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Run until queue + slots drain; returns {req_id: generated}."""
        for _ in range(max_steps):
            if (not self.queue and self._pending is None
                    and all(r is None for r in self.slots)):
                break
            self.step()
        return {rid: r.generated for rid, r in self.requests.items()}
