"""Quickstart: Stamp-it protecting a lock-free data structure (host plane),
on the PyTorch port's copy of the reclamation schemes.

Four threads hammer a shared Michael&Scott queue and a Harris list-based
set; every retired node flows through Stamp-it's stamped retire lists.
Swap ``--scheme`` for any of the eight implemented schemes.  The host
plane runs no device work.

    PYTHONPATH=src python examples/quickstart_torch.py [--scheme stamp-it]
"""

import argparse
import random
import threading

from repro_torch.core import SCHEMES, make_reclaimer
from repro_torch.core.ds import HarrisMichaelListSet, MichaelScottQueue


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheme", default="stamp-it", choices=sorted(SCHEMES))
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--ops", type=int, default=3000)
    args = ap.parse_args(argv)

    r = make_reclaimer(args.scheme)
    queue = MichaelScottQueue(r)
    lset = HarrisMichaelListSet(r)

    def worker(idx: int) -> None:
        rng = random.Random(idx)
        with r.thread_context():
            i = 0
            while i < args.ops:
                with r.region_guard():  # amortize region entry (paper §2)
                    for _ in range(100):
                        k = rng.randrange(40)
                        action = rng.random()
                        if action < 0.3:
                            queue.enqueue(k)
                        elif action < 0.6:
                            queue.dequeue()
                        elif action < 0.8:
                            lset.insert(k)
                        else:
                            lset.remove(k)
                        i += 1

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(args.threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    # drain + flush
    with r.thread_context():
        queue.drain()
        for _ in range(300):
            with r.region_guard():
                pass
        r.flush()
    s = r.stats()
    print(f"scheme={args.scheme} allocated={s['allocated']} "
          f"reclaimed={s['reclaimed']} unreclaimed={s['unreclaimed']}")
    if hasattr(r, "scan_steps"):
        per = r.scan_steps.load() / max(s["reclaimed"], 1)
        print(f"reclamation work: {per:.3f} nodes touched per reclaimed "
              f"node (amortized O(1) for stamp-it)")
    return s


if __name__ == "__main__":
    main()
