"""End-to-end driver on the PyTorch port: serve a small model with batched
requests through the continuous-batching engine — paged KV cache, prefix
cache, and pluggable page reclamation under asynchronous dispatch — on
the card (``--device cuda``, the default: the paged decode, flash prefill
and block-gather CUDA kernels) or on the CPU (``--device cpu``: their
plain PyTorch versions).  Any of the paper's seven schemes (plus the
native analogues) is selectable via ``--policy``; with ``--temperature``
the fused decode step samples on device.  ``--best-of N`` forks every
prompt into N copy-on-write branches that share its prompt pages;
``--speculate K`` drafts K tokens per fused dispatch with the
truncated-model speculative lane (greedy only).

    PYTHONPATH=src python examples/serve_paged_torch.py --policy hazard
    PYTHONPATH=src python examples/serve_paged_torch.py --best-of 4 --speculate 2
    PYTHONPATH=src python examples/serve_paged_torch.py --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.memory import POLICIES
from repro_torch.models import Model
from repro_torch.serving import ServingEngine


def device_name(dev: torch.device) -> str:
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "CPU")


def main(argv=None) -> ServingEngine:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="stamp-it",
                    choices=sorted(POLICIES))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--chunk-tokens", type=int, default=128,
                    help="prefill chunk size in tokens, a multiple of "
                         "the 128-token KV page (default: 128 — chunked "
                         "prefill inside the fused step, one compiled "
                         "chunk shape, bounded TTFT); 0 = legacy "
                         "whole-prompt prefill dispatch")
    ap.add_argument("--best-of", type=int, default=1,
                    help="fork each prompt into N copy-on-write branches "
                         "sharing its prompt pages (one prefill per "
                         "group; losers retire as one batch)")
    ap.add_argument("--speculate", type=int, default=0,
                    help="draft K tokens per fused dispatch via the "
                         "speculative lane (greedy decoding only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda, the "
                         "CUDA kernels; cpu runs their plain versions)")
    args = ap.parse_args(argv)
    if args.speculate and args.temperature != 0.0:
        ap.error("--speculate requires greedy decoding (--temperature 0)")

    model = Model(smoke_config(ARCHS["granite-3-8b"]), device=args.device)
    eng = ServingEngine(
        model, max_slots=max(3, args.best_of), max_seq=512,
        policy=args.policy, pipeline_depth=3, prefix_cache_entries=16,
        extra_pages_per_slot=4, temperature=args.temperature,
        top_p=args.top_p, chunk_tokens=args.chunk_tokens,
        speculate_k=args.speculate, device=model.device,
    )
    rs = np.random.RandomState(0)
    shared_prefix = list(rs.randint(1, 500, 128).astype(int))
    groups = []
    for i in range(args.requests):
        # half the requests share a 128-token prefix (prefix-cache hits)
        if i % 2 == 0:
            prompt = shared_prefix + list(
                rs.randint(1, 500, rs.randint(5, 60)).astype(int))
        else:
            prompt = list(rs.randint(1, 500, rs.randint(50, 250)).astype(int))
        if args.best_of > 1:
            groups.append(eng.fork_submit(prompt, args.best_of,
                                          max_new_tokens=args.max_new))
        else:
            eng.submit(prompt, max_new_tokens=args.max_new)

    t0 = time.perf_counter()
    done = eng.run_until_done()
    dt = time.perf_counter() - t0
    eng.drain()

    toks = sum(len(r.generated) for r in done)
    print(f"policy={args.policy}  requests={len(done)}  "
          f"generated={toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s on {device_name(model.device)})")
    for r in done[:4]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.generated}")
    s = eng.stats()
    print(f"engine steps: {s['steps']}  "
          f"dispatches/step: {s['dispatches_per_step']:.1f}  "
          f"prefill chunks: {s['prefill_chunks']}  "
          f"prefix hits/misses: "
          f"{s['prefix_hits']}/{s['prefix_misses']}  "
          f"pages recycled: {s['pool_freed']}  "
          f"unreclaimed after drain: {s['pool_unreclaimed']}")
    if args.best_of > 1 or args.speculate:
        print(f"cow/spec: groups={len(groups)}  "
              f"fork refs taken/released: "
              f"{s['forks_taken']}/{s['forks_released']}  "
              f"partial-page copies: {s['cow_copies']}  "
              f"spec acceptance: {s['spec_acceptance']:.2f}  "
              f"tokens/dispatch: {s['tokens_per_dispatch']:.2f}")
    return eng


if __name__ == "__main__":
    main()
