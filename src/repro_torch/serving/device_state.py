"""Device plane of the serving engine: state tensors + the fused step.

``DeviceState`` owns every tensor the decode loop touches on the card —
the token chain, per-slot lengths, block table, active mask,
allocated-page counts and the prefill first-token buffer — and applies
ONE transition per engine step (``stats()["dispatches_per_step"] == 1``):
reset -> prefill chunk -> admit -> teacher-force -> grow -> decode ->
sample, as the JAX package's ``repro/serving/device_state.py``.

Page-growth ALLOCATION is decided on the device: the step computes the
per-slot need mask from the device-resident lengths
(``lengths // block + 1 > pages``) and consumes host-supplied candidate
page ids for exactly the slots the mask selects.  The host never reads
device lengths; it advances a deterministic mirror that agrees with the
device by construction (see the scheduler).

PyTorch runs eagerly and CUDA launches are asynchronous, so the host
enqueues step N+1 while the card still runs step N; the engine keeps up
to ``pipeline_depth`` steps in flight and syncs only when it reads a
step's tokens (``_complete_oldest``).  Differences from the JAX step:

  * the KV pools are updated IN PLACE (JAX donated them); lengths,
    table, mask, pages and first_buf are small and rebuilt out of place;
  * the token chain is never written in place: each in-flight pipeline
    entry keeps its step's ``tokens`` tensor until the host reads it;
  * lanes with nothing staged are skipped (JAX ran every lane with zero
    masks because its compiled signature was fixed); the growth lane
    always runs, since the device decides it;
  * staged operands go to the device as ordinary copies of fresh numpy
    arrays, never through a reused pinned buffer an in-flight copy may
    still read;
  * the chunk lane samples only on a prompt's final chunk (JAX samples
    every chunk and keeps the final one's), and that token's uniform
    comes from the numpy twin on the host, since its inputs are host
    scalars;
  * the speculative lane's draft writes its KV into the REAL pools of
    its layers, in place (JAX wrote into a sliced copy it discarded):
    every position a draft step writes, lengths .. lengths + k - 1, is
    written again by a verify step before any step reads it, so the
    pools after the step equal JAX's.

Whole-prompt prefill (``chunk_tokens=0``, :meth:`DeviceState.prefill`)
is one admission dispatch per request: the forward pass over the prompt
padded to a power-of-two bucket (the flash kernel), the first token
sampled on the card into ``first_buf``, and the K/V scattered into the
slot's pages, the bucket's spare blocks onto the scratch page 0.

The speculative lane (``speculate_k = k > 0``, greedy only) folds
draft-and-verify into the same step: k draft steps over the first
``draft_layers`` layers, then k + 1 verify steps of the whole model
teacher-forcing ``[t0, d1 .. dk]``; a slot advances by the accepted
prefix plus the verifier's own token (``counts``), which the host reads
back.

Sampling runs on the card inside the same step: temperature/top-p by
sorted inverse CDF (:func:`sample_tokens`), greedy argmax when
``temperature == 0``.  The uniforms are counter-based: each slot carries
its request's ``sample_key`` and the u for the token at sequence index
``pos`` is :func:`~repro_torch.serving.rng.counter_uniform` of ``(key,
pos)``, bit-identical to the JAX package's, so a sampled continuation
does not depend on the engine that serves it.
``repro_torch.serving.sampling`` holds the host reference.

Page copies (``copy_pages``: copy-on-write fork admission, prefix-cache
replay) gather every layer's source pages with one block-gather launch
per pool (``ops.block_gather``), then write them into the destination
pages with one indexed copy.

Page moves between replicas (the cluster plane's cold path: each replica
owns its own pools, so a move goes through the host) are
:meth:`DeviceState.read_pages` — one block-gather launch per pool over
every layer, then one copy to the host — and
:meth:`DeviceState.write_pages` — one copy to the card and one indexed
copy per pool.  The host payload is a pair of CPU tensors in the pool's
dtype.  Both pad their page list to a power of two
(``page_move_buckets``, as the JAX package keeps its compiled shapes
few); pad lanes read, and write, the slot's scratch page 0.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from .rng import counter_uniform, counter_uniform_np


def sample_tokens(logits: torch.Tensor, u: torch.Tensor,
                  temperature: float, top_p: float) -> torch.Tensor:
    """Temperature/top-p sampling by sorted inverse CDF, in f32.

    ``logits`` (B, V), ``u`` (B,) uniforms; returns (B,) int32 token ids.
    Step for step the JAX package's ``sample_tokens`` (a stable
    descending sort in place of ``argsort(-lf)``), mirrored on the host
    by :func:`repro_torch.serving.sampling.sample_ref`; float
    associativity is the only divergence."""
    lf = logits.to(torch.float32) / temperature
    s, order = torch.sort(lf, dim=-1, descending=True, stable=True)
    e = torch.exp(s - s[:, :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1)
    # nucleus: smallest prefix with cumulative mass >= top_p
    keep = (cum - probs) < top_p
    kept = torch.where(keep, probs, torch.zeros_like(probs))
    kept = kept / kept.sum(dim=-1, keepdim=True)
    kcum = torch.cumsum(kept, dim=-1)
    last = keep.sum(dim=-1) - 1
    idx = torch.minimum((kcum <= u[:, None]).sum(dim=-1), last)
    return torch.gather(order, 1, idx[:, None])[:, 0].to(torch.int32)


class DeviceState:
    """Device-resident serving state with a single fused step transition.

    Host-side events (admission, prefill chunks, finish, teacher-forcing)
    are *staged* and applied INSIDE the next step, in order: reset ->
    prefill-chunk -> admit -> teacher-force -> grow -> decode -> sample.
    The chunk lane runs BEFORE the admit lane so a prompt's final chunk
    can write the first token into ``first_buf`` and the admit staged for
    the same step can consume it.
    """

    def __init__(
        self,
        model,
        params,
        cache,
        *,
        max_slots: int,
        mb: int,
        block: int,
        chunk_tokens: int = 0,
        temperature: float = 0.0,
        top_p: float = 1.0,
        speculate_k: int = 0,
        draft_layers: int = 0,
        impl: Optional[str] = None,
    ) -> None:
        if chunk_tokens < 0 or chunk_tokens % block:
            raise ValueError(
                f"chunk_tokens must be 0 or a positive multiple of {block}")
        if not 0 <= speculate_k < block:
            # device growth stays at most one page per slot per step
            raise ValueError(f"speculate_k must lie in [0, {block})")
        if speculate_k and not 0 < draft_layers <= model.cfg.num_layers:
            raise ValueError("draft_layers must lie in [1, num_layers]")
        self.model = model
        self.params = params
        self.cache = cache
        self.max_slots = max_slots
        self.mb = mb
        self.block = block
        # chunked-prefill lane width (0: lane off, whole-prompt prefill)
        self.chunk_tokens = int(chunk_tokens)
        self.chunk_shapes: set = set()
        # whole-prompt prefill: the bucketed prompt lengths seen
        self.prefill_shapes: set = set()
        # speculative lane: the draft is the first `draft_layers` layers
        # of the target model (a config cut to that depth)
        self.speculate_k = int(speculate_k)
        self.draft_layers = int(draft_layers)
        self._draft = (model.with_layers(self.draft_layers)
                       if self.speculate_k else None)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        # None: the tensors' device picks kernel or plain; "plain" runs
        # the plain attention everywhere (comparison runs only)
        self.impl = impl
        dev = model.device
        self.device = dev

        B = max_slots
        i32 = dict(dtype=torch.int32, device=dev)
        self.tokens = torch.zeros((B, 1), **i32)
        self.lengths = torch.zeros((B,), **i32)
        self.table = torch.zeros((B, mb), **i32)
        self.mask = torch.zeros((B,), **i32)
        self.pages = torch.zeros((B,), **i32)
        self.first_buf = torch.zeros((B,), **i32)
        # per-slot sample keys, installed at admit: a token's uniform is
        # a pure function of (key, position), see counter_uniform
        self.seeds = torch.zeros((B,), **i32)
        self._rows = torch.arange(B, device=dev)

        # staged host events, applied by the next step
        self._pending_resets: List[int] = []
        self._pending_admits: List[Tuple] = []
        self._pending_chunk: Optional[Tuple] = None
        self.stage_ns = 0  # host time spent building step operands

        # dispatch accounting: every device step made on behalf of an
        # engine step bumps decode_dispatches (the engine counts steps);
        # out-of-step device work (prefix-cache page copies) counts as
        # admission work
        self.decode_dispatches = 0
        self.admission_dispatches = 0
        self.migration_dispatches = 0  # cluster plane, cold path
        self.page_move_buckets: set = set()  # pow2 page-move index sizes

    # ------------------------------------------------------------------
    # staging API (host events -> next step)
    # ------------------------------------------------------------------
    def stage_reset(self, slot: int) -> None:
        self._pending_resets.append(slot)

    def stage_admit(self, slot: int, length: int, row: np.ndarray,
                    n_pages: int, *, token: int = 0,
                    token_from_buf: bool = False,
                    set_token: bool = False, seed: int = 0) -> None:
        self._pending_admits.append(
            (slot, length, np.array(row, np.int32), n_pages, token,
             token_from_buf, set_token, seed))

    def has_pending_chunk(self) -> bool:
        """True when a prefill chunk is staged for the next step (the
        engine must dispatch even with no active decode slots)."""
        return self._pending_chunk is not None

    def prefill_jit_shapes(self) -> list:
        """The bucketed prompt lengths whole-prompt prefill has run at
        (powers of two times the page size); empty for chunked
        engines."""
        return sorted(self.prefill_shapes)

    def stage_chunk(self, slot: int, tokens: np.ndarray, start: int,
                    row: np.ndarray, pages: np.ndarray, is_last: bool,
                    last_index: int, seed: int = 0) -> None:
        """Stage one prefill chunk for the next step.  At most one chunk
        rides per step; ``tokens`` is always exactly ``chunk_tokens`` wide
        (the last chunk pads), so the lane has ONE shape."""
        if len(tokens) != self.chunk_tokens:
            raise ValueError(f"chunk of {len(tokens)} tokens, lane is "
                             f"{self.chunk_tokens} wide")
        if self._pending_chunk is not None:
            raise RuntimeError("one chunk per fused step")
        self.chunk_shapes.add(len(tokens))
        self._pending_chunk = (slot, np.array(tokens, np.int32), int(start),
                               np.array(row, np.int32),
                               np.array(pages, np.int32), bool(is_last),
                               int(last_index), int(seed))

    # ------------------------------------------------------------------
    # out-of-step device work
    # ------------------------------------------------------------------
    def prefill(self, tokens_np: np.ndarray, last_index: int, slot: int,
                nb: int, pages, seed: int = 0) -> torch.Tensor:
        """Whole-prompt prefill of one admission, ONE dispatch: forward
        pass over ``tokens_np`` (1, S), S a power-of-two bucket of pages,
        the first token sampled on the card into ``first_buf[slot]``, and
        each layer's K/V written into the slot's ``nb`` pages ``pages``;
        the bucket's spare blocks go to the scratch page 0, as in the JAX
        package.  For the MoE family the bucket's pad tokens are routed
        with the prompt's and compete for expert capacity (worked out
        from the bucket's length), as in the JAX package: a prompt's
        first token may differ from its chunked prefill's where pairs
        drop.  Returns the first token, a 0-d tensor on the card."""
        S = tokens_np.shape[1]
        if S % self.block:
            raise ValueError(f"prompt bucket {S} is not whole pages")
        self.prefill_shapes.add(S)
        toks = self._upload(np.asarray(tokens_np, np.int32))
        logits, kv = self.model.prefill(
            self.params,
            {"tokens": toks,
             "last_index": self._upload(np.array([last_index], np.int32))},
            impl=self.impl)
        if self.temperature > 0.0:
            # token 1's sequence index is last_index + 1, the prompt
            # length; its uniform is a function of host scalars
            u = self._upload(counter_uniform_np([seed], [last_index + 1]))
            first = sample_tokens(logits, u, self.temperature,
                                  self.top_p)[0]
        else:
            first = torch.argmax(logits, dim=-1).to(torch.int32)[0]
        layers = self.cache["layers"]
        L, B, N = layers["k_pool"].shape[:3]
        nbk = S // self.block
        dst = torch.from_numpy(np.asarray(
            list(pages) + [0] * (nbk - nb), np.int64) + slot * N).to(
                self.device)
        for name, t in (("k_pool", kv["k"]), ("v_pool", kv["v"])):
            pool = layers[name]
            blocks = t[:, 0].reshape(L, nbk, self.block, *t.shape[3:])
            pool.view(L, B * N, *pool.shape[3:]).index_copy_(
                1, dst, blocks.to(pool.dtype))
        self.first_buf = self.first_buf.clone()
        self.first_buf[slot] = first
        self.admission_dispatches += 1
        return first

    def copy_pages(self, src_slots, src_pages, dst_slot: int,
                   dst_pages) -> None:
        """Copy pages (every layer) into ``dst_slot``'s pages, in place:
        the JAX package's ``_copy_fn``.  Each pool ``(L, B, N_pool,
        *page)`` is viewed as ``(L * B * N_pool, *page)``; one block
        gather reads every layer's source pages into a buffer and one
        indexed copy writes the buffer into the destination pages, so a
        source page that is also a destination is read before it is
        written, as in the JAX package."""
        layers = self.cache["layers"]
        L, B, N = layers["k_pool"].shape[:3]
        ss = np.asarray(src_slots, np.int64)
        sp = np.asarray(src_pages, np.int64)
        dp = np.asarray(dst_pages, np.int64)
        if not (ss.shape == sp.shape == dp.shape and ss.ndim == 1):
            raise ValueError("one source slot and page per destination")
        for name, a, hi in (("src slot", ss, B), ("src page", sp, N),
                            ("dst page", dp, N)):
            if a.size and (a.min() < 0 or a.max() >= hi):
                raise IndexError(f"{name} outside [0, {hi})")
        if not 0 <= dst_slot < B:
            raise IndexError(f"dst slot {dst_slot} outside [0, {B})")
        base = np.arange(L, dtype=np.int64)[:, None] * (B * N)
        src = torch.from_numpy(
            (base + ss * N + sp).reshape(-1).astype(np.int32))
        dst = torch.from_numpy(
            (base + dst_slot * N + dp).reshape(-1)).to(self.device)
        for name in ("k_pool", "v_pool"):
            pool = layers[name]
            flat = pool.view(L * B * N, *pool.shape[3:])
            pages = ops.block_gather(flat, src, impl=self.impl)
            flat.index_copy_(0, dst, pages)
        self.admission_dispatches += 1

    # ------------------------------------------------------------------
    # cluster-plane page moves (cold path: replicas own separate pools,
    # so cross-replica moves go through the host)
    # ------------------------------------------------------------------
    def _page_move_bucket(self, n: int) -> int:
        """Power-of-two bucket of a page move's index vector; the
        buckets seen are kept in ``page_move_buckets``."""
        b = 1
        while b < n:
            b <<= 1
        self.page_move_buckets.add(b)
        return b

    def _page_move_index(self, slot: int, pages):
        """(flat index over every layer of the ``(L * B * N_pool,
        *page)`` pool view, n, bucket, pool dims): layer-major, each
        layer's ``n`` pages padded to the bucket with the slot's scratch
        page 0."""
        L, B, N = self.cache["layers"]["k_pool"].shape[:3]
        if not 0 <= slot < B:
            raise IndexError(f"slot {slot} outside [0, {B})")
        p = np.asarray(list(pages), np.int64)
        n = len(p)
        if n == 0:
            raise ValueError("a page move needs at least one page")
        if p.min() < 0 or p.max() >= N:
            raise IndexError(f"page outside [0, {N})")
        nb = self._page_move_bucket(n)
        p = np.concatenate([p, np.zeros(nb - n, np.int64)])
        idx = (np.arange(L, dtype=np.int64)[:, None] * (B * N)
               + slot * N + p[None, :]).reshape(-1)
        return idx, n, nb, (L, B, N)

    def read_pages(self, slot: int, pages) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """Pull one slot's pages to the host: a ``(L, n, block, Hkv, D)``
        k/v pair of CPU tensors in the pool's dtype.  One block-gather
        launch per pool reads every layer's pages, then one copy moves
        them to the host; synchronous, since the caller holds a cluster
        hold over the pages and a migration is not the hot path."""
        idx, n, nb, (L, B, N) = self._page_move_index(slot, pages)
        src = torch.from_numpy(idx.astype(np.int32))
        out = []
        for name in ("k_pool", "v_pool"):
            pool = self.cache["layers"][name]
            flat = pool.view(L * B * N, *pool.shape[3:])
            got = ops.block_gather(flat, src, impl=self.impl)
            out.append(got.view(L, nb, *pool.shape[3:])[:, :n].to("cpu"))
        self.migration_dispatches += 1
        return out[0], out[1]

    def write_pages(self, slot: int, pages, k: torch.Tensor,
                    v: torch.Tensor) -> None:
        """Install host K/V pages (``read_pages``' payload, in the pool's
        dtype) into this slot's ``pages``.  The index is padded to the
        bucket with the scratch page 0 and the payload with zeros, so pad
        lanes write the scratch page, as inactive slots' decode writes
        do."""
        idx, n, nb, (L, B, N) = self._page_move_index(slot, pages)
        dst = torch.from_numpy(idx).to(self.device)
        for name, host in (("k_pool", k), ("v_pool", v)):
            pool = self.cache["layers"][name]
            page = tuple(pool.shape[3:])
            if tuple(host.shape) != (L, n, *page):
                raise ValueError(f"{name} payload {tuple(host.shape)}, "
                                 f"pages are {(L, n, *page)}")
            if host.dtype != pool.dtype:
                raise TypeError(f"{name} payload is {host.dtype}, the pool "
                                f"{pool.dtype}")
            buf = pool.new_zeros((L, nb, *page))
            buf[:, :n].copy_(host)
            pool.view(L * B * N, *page).index_copy_(
                0, dst, buf.view(L * nb, *page))
        self.migration_dispatches += 1

    # ------------------------------------------------------------------
    # the fused step
    # ------------------------------------------------------------------
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def dispatch(self, tf: Dict[int, int], grow: Dict[int, int],
                 n_kv: int):
        """Run ONE fused engine step; returns ``(tokens, chunk_first,
        spec)`` — the new token chain (B, 1), the chunk lane's first-token
        scalar (None unless a chunk rode this step; meaningful only when
        it was a prompt's last) and, with the speculative lane, ``(v,
        counts)``: the verifier's tokens (B, k + 1) and each slot's
        advance (B,), 0 for inactive slots (else None).

        ``tf``   — slot -> teacher-forced token for this step.
        ``grow`` — slot -> candidate page id (consumed iff the device need
                   mask selects the slot).
        """
        t0 = time.perf_counter_ns()
        B, mb = self.max_slots, self.mb
        reset_m = admit = tf_ops = None
        if self._pending_resets:
            m = np.zeros((B,), np.int32)
            m[self._pending_resets] = 1
            reset_m = self._upload(m)
        if self._pending_admits:
            a = {k: np.zeros((B,), np.int32)
                 for k in ("m", "len", "pages", "tok", "from_buf", "set",
                           "seed")}
            a_row = np.zeros((B, mb), np.int32)
            for (slot, length, row, n_pages, tok, from_buf, set_tok,
                 seed) in self._pending_admits:
                a["m"][slot] = 1
                a["len"][slot] = length
                a_row[slot] = row
                a["pages"][slot] = n_pages
                a["tok"][slot] = tok
                a["from_buf"][slot] = 1 if from_buf else 0
                a["set"][slot] = 1 if set_tok else 0
                a["seed"][slot] = seed
            admit = {k: self._upload(v) for k, v in a.items()}
            admit["row"] = self._upload(a_row)
        if tf:
            tf_m = np.zeros((B,), np.int32)
            tf_vals = np.zeros((B,), np.int32)
            for slot, tok in tf.items():
                tf_m[slot] = 1
                tf_vals[slot] = tok
            tf_ops = (self._upload(tf_m), self._upload(tf_vals))
        cand = np.zeros((B,), np.int32)
        for slot, page in grow.items():
            cand[slot] = page
        cand_d = self._upload(cand)
        chunk = None
        if self._pending_chunk is not None:
            (c_slot, c_toks, c_start, c_row, c_pages, c_is_last,
             c_last_index, c_seed) = self._pending_chunk
            c_u = None
            if c_is_last and self.temperature > 0.0:
                # token 1 lands at sequence index start + last_index + 1
                # (the prompt length); its uniform is a function of host
                # scalars, so the numpy twin computes it here
                c_u = self._upload(counter_uniform_np(
                    [c_seed], [c_start + c_last_index + 1]))
            chunk = (c_slot, self._upload(c_toks[None]), c_start,
                     self._upload(c_row), self._upload(c_pages), c_is_last,
                     c_last_index, c_u)
        self.stage_ns += time.perf_counter_ns() - t0

        tokens, chunk_first, spec = self._step(reset_m, admit, tf_ops,
                                               cand_d, chunk, n_kv)
        self._pending_resets.clear()
        self._pending_admits.clear()
        self._pending_chunk = None
        self.decode_dispatches += 1
        return tokens, chunk_first, spec

    def _step(self, reset_m, admit, tf_ops, cand, chunk, n_kv: int):
        lengths, table, mask = self.lengths, self.table, self.mask
        pages, first_buf, tokens = self.pages, self.first_buf, self.tokens
        seeds = self.seeds

        # 1. slot resets (requests finished since the last step)
        if reset_m is not None:
            keep = 1 - reset_m
            lengths = lengths * keep
            mask = mask * keep
            pages = pages * keep
            seeds = seeds * keep
            table = table * keep[:, None]

        # 1b. chunked-prefill lane (at most ONE chunk per step).  On the
        # prompt's final chunk the first token is sampled HERE and put in
        # first_buf, which the admit lane below consumes; other chunks
        # sample nothing.
        chunk_first = None
        if chunk is not None:
            c_slot, c_toks, c_start, c_row, c_pages, c_last, c_li, c_u = chunk
            ck_logits, self.cache = self.model.prefill_chunk(
                self.params, self.cache,
                {"tokens": c_toks, "start": c_start, "row": c_row,
                 "pages": c_pages, "last_index": c_li},
                n_kv=n_kv, global_pages=True, impl=self.impl)
            if c_last:
                if c_u is not None:
                    chunk_first = sample_tokens(ck_logits, c_u,
                                                self.temperature,
                                                self.top_p)[0]
                else:
                    chunk_first = torch.argmax(ck_logits, dim=-1).to(
                        torch.int32)[0]
                first_buf = first_buf.clone()
                first_buf[c_slot] = chunk_first

        # 2. admissions
        if admit is not None:
            on = admit["m"] == 1
            lengths = torch.where(on, admit["len"], lengths)
            table = torch.where(on[:, None], admit["row"], table)
            mask = torch.maximum(mask, admit["m"])
            pages = torch.where(on, admit["pages"], pages)
            seeds = torch.where(on, admit["seed"], seeds)
            first = torch.where(admit["from_buf"] == 1, first_buf,
                                admit["tok"])
            tokens = torch.where(admit["set"][:, None] == 1, first[:, None],
                                 tokens)

        # 3. teacher-forced suffix overrides (prefix-cache replay)
        if tf_ops is not None:
            tf_m, tf_vals = tf_ops
            tokens = torch.where(tf_m[:, None] == 1, tf_vals[:, None],
                                 tokens)

        # 4. device-side page growth: the need mask comes from the DEVICE
        # lengths; the host only supplied per-slot candidates.  The
        # speculative lane writes up to k positions past `lengths` this
        # step, so the horizon extends by k — still at most one page per
        # slot per step because k < block.
        look = self.speculate_k
        need = ((mask == 1) & (((lengths + look) // self.block + 1) > pages)
                & (pages < self.mb))
        pos = torch.clamp(pages, 0, self.mb - 1).long()
        cur = table[self._rows, pos]
        table = table.clone()
        table[self._rows, pos] = torch.where(need, cand, cur)
        pages = pages + need.to(torch.int32)
        self.table, self.mask, self.pages = table, mask, pages
        self.first_buf, self.seeds = first_buf, seeds

        if self.speculate_k:
            tf_m = tf_ops[0] if tf_ops is not None else None
            tokens, counts, v = self._speculate(tokens, lengths, table,
                                                mask, tf_m, n_kv)
            self.tokens = tokens
            self.lengths = lengths + counts
            return tokens, chunk_first, (v, counts)

        # 5. decode
        logits, self.cache = self.model.decode_step(
            self.params, self.cache,
            {"tokens": tokens, "lengths": lengths, "block_table": table},
            n_kv=n_kv, global_pages=True, impl=self.impl)

        # 6. sample: the token this step emits lands at sequence index
        # lengths + 1 (index `lengths` holds the token being consumed)
        new_tokens = self._sample(logits, seeds, lengths)[:, None]
        self.tokens = new_tokens
        self.lengths = lengths + mask
        return new_tokens, chunk_first, None

    def _speculate(self, tokens, lengths, table, mask, tf_m, n_kv: int):
        """5s. Draft-and-verify (greedy), inside the step.  Draft: k
        steps over the first ``draft_layers`` layers (views of the
        params and of the pools: its K/V writes land in the real pools
        and the verify pass writes the same positions again before any
        read).  Verify: k + 1 steps of the whole model teacher-forcing
        ``[t0, d1 .. dk]``; v_i is the target's token for position
        lengths + i + 1, the token non-speculative greedy decode gives
        there.  Returns (next tokens (B, 1), counts (B,) — accepted + 1
        for active slots, 0 for inactive ones —, v (B, k + 1))."""
        k, dl = self.speculate_k, self.draft_layers
        paged = dict(n_kv=n_kv, global_pages=True, impl=self.impl)

        def cut(tree):
            return {n: cut(a) if isinstance(a, dict) else a[:dl]
                    for n, a in tree.items()}

        dparams = dict(self.params, layers=cut(self.params["layers"]))
        dcache = dict(self.cache, layers=cut(self.cache["layers"]))
        d_tok, d_len, drafts = tokens, lengths, []
        for _ in range(k):
            d_logits, _ = self._draft.decode_step(
                dparams, dcache,
                {"tokens": d_tok, "lengths": d_len, "block_table": table},
                **paged)
            nxt = torch.argmax(d_logits, dim=-1).to(torch.int32)
            drafts.append(nxt)
            d_tok, d_len = nxt[:, None], d_len + 1
        v_tok, v_len, v_list = tokens, lengths, []
        for i in range(k + 1):
            logits, self.cache = self.model.decode_step(
                self.params, self.cache,
                {"tokens": v_tok, "lengths": v_len, "block_table": table},
                **paged)
            v_list.append(torch.argmax(logits, dim=-1).to(torch.int32))
            if i < k:
                v_tok, v_len = drafts[i][:, None], v_len + 1
        v = torch.stack(v_list, dim=1)
        d = torch.stack(drafts, dim=1)
        # the longest prefix of drafts the target agrees with, plus the
        # verifier's own token; slots mid teacher-forcing advance 1 as in
        # a plain step (the forced token overrides their drafts)
        acc = torch.cumprod((d == v[:, :k]).to(torch.int32), dim=1)
        spec_m = mask == 1
        if tf_m is not None:
            spec_m = spec_m & (tf_m == 0)
        counts = torch.where(spec_m, acc.sum(dim=1).to(torch.int32) + 1,
                             torch.ones_like(mask))
        new_tokens = torch.gather(v, 1, (counts - 1)[:, None].long())
        return new_tokens, counts * mask, v

    def _sample(self, logits: torch.Tensor, seeds: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        """The decode lane's sampler: (B,) int32 tokens.  Greedy takes
        the first maximal index, as ``jnp.argmax``; sampled mode draws
        with ``counter_uniform(seed, lengths + 1)`` on the card."""
        if self.temperature > 0.0:
            u = counter_uniform(seeds, lengths + 1)
            return sample_tokens(logits, u, self.temperature, self.top_p)
        return torch.argmax(logits, dim=-1).to(torch.int32)
