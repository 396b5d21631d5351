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
    scalars.

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
        chunk_tokens: int,
        temperature: float = 0.0,
        top_p: float = 1.0,
        impl: Optional[str] = None,
    ) -> None:
        if chunk_tokens <= 0 or chunk_tokens % block:
            raise ValueError(
                f"chunk_tokens must be a positive multiple of {block}")
        self.model = model
        self.params = params
        self.cache = cache
        self.max_slots = max_slots
        self.mb = mb
        self.block = block
        self.chunk_tokens = int(chunk_tokens)
        self.chunk_shapes: set = set()
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
    # the fused step
    # ------------------------------------------------------------------
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def dispatch(self, tf: Dict[int, int], grow: Dict[int, int],
                 n_kv: int):
        """Run ONE fused engine step; returns ``(tokens, chunk_first)`` —
        the new token chain (B, 1) and the chunk lane's first-token
        scalar (None unless a chunk rode this step; meaningful only when
        it was a prompt's last).

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

        tokens, chunk_first = self._step(reset_m, admit, tf_ops, cand_d,
                                         chunk, n_kv)
        self._pending_resets.clear()
        self._pending_admits.clear()
        self._pending_chunk = None
        self.decode_dispatches += 1
        return tokens, chunk_first

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
        # lengths; the host only supplied per-slot candidates
        need = ((mask == 1) & ((lengths // self.block + 1) > pages)
                & (pages < self.mb))
        pos = torch.clamp(pages, 0, self.mb - 1).long()
        cur = table[self._rows, pos]
        table = table.clone()
        table[self._rows, pos] = torch.where(need, cand, cur)
        pages = pages + need.to(torch.int32)

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
        self.table, self.mask, self.pages = table, mask, pages
        self.first_buf, self.seeds = first_buf, seeds
        return new_tokens, chunk_first

    def _sample(self, logits: torch.Tensor, seeds: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        """The decode lane's sampler: (B,) int32 tokens.  Greedy takes
        the first maximal index, as ``jnp.argmax``; sampled mode draws
        with ``counter_uniform(seed, lengths + 1)`` on the card."""
        if self.temperature > 0.0:
            u = counter_uniform(seeds, lengths + 1)
            return sample_tokens(logits, u, self.temperature, self.top_p)
        return torch.argmax(logits, dim=-1).to(torch.int32)
