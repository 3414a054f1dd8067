"""The traffic's producer: a process of its own that makes fresh reads from
the seed and offers them through named pipes (FIFOs), as ``bwa mem ref
<(zcat r1.fq.gz) <(zcat r2.fq.gz)`` users do.

It opens pipe 1, writes batch 0 of read 1, opens pipe 2 (pairs), writes
batch 0 of read 2, and goes on a whole batch of read 1 before the same batch
of read 2, so the aligner's lockstep reader never waits on the other pipe.
Before each batch it stops once ``--seconds`` have passed since the first
read was offered, or after ``--batches`` batches, and closes the pipes.  A
thread makes the next batches while the writer waits on the pipe.  Its last
stdout line is a JSON record: the time the first read was offered
(``time.monotonic``, which every process of the host shares), the batches
and reads offered, the seconds the pipes waited for a batch to be made
(``starved_s``: where that is more than a sliver of the window, the
producer and not the aligner set the pace), and the time it closed the
pipes.

    python -m portbench.producer --text GENOME.npy --traffic T.json \
        --seed N --stream K --seconds S [--batches M] FIFO1 [FIFO2]
"""
from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time

import numpy as np

from portbench.gen.reads import make_batch

AHEAD = 2  # batches made ahead of the writer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--text", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--stream", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--batches", type=int, default=None)
    ap.add_argument("fifos", nargs="+")
    a = ap.parse_args(argv)
    with open(a.traffic) as f:
        traffic = json.load(f)
    if len(a.fifos) != traffic["ends"]:
        raise SystemExit(f"{traffic['ends']} pipes needed, "
                         f"{len(a.fifos)} given")
    text = np.load(a.text, mmap_mode="r")
    made: queue.Queue = queue.Queue(AHEAD)
    stop = threading.Event()

    def put(item) -> None:
        while not stop.is_set():
            try:
                made.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def maker() -> None:
        k = 0
        while not stop.is_set() and (a.batches is None or k < a.batches):
            b = make_batch(text, traffic, a.seed, a.stream, k)
            put([b.fastq(e) for e in range(traffic["ends"])])
            k += 1
        put(None)

    th = threading.Thread(target=maker, daemon=True)
    th.start()
    outs = [None] * len(a.fifos)
    t_first = None
    n_batches = 0
    starved = 0.0   # seconds the pipes waited for a batch to be made
    try:
        while True:
            if t_first is not None and \
                    time.monotonic() - t_first >= a.seconds:
                break
            t = time.monotonic()
            item = made.get()
            if t_first is not None:
                starved += time.monotonic() - t
            if item is None:
                break
            for e, data in enumerate(item):
                if outs[e] is None:
                    outs[e] = open(a.fifos[e], "wb")
                if t_first is None:
                    t_first = time.monotonic()
                outs[e].write(data)
                outs[e].flush()
            n_batches += 1
    finally:
        stop.set()
        for e, path in enumerate(a.fifos):
            if outs[e] is None:   # never opened: let the reader see EOF
                outs[e] = open(path, "wb")
            outs[e].close()
        th.join(timeout=30)
    print(json.dumps({"t_first": t_first, "batches": n_batches,
                      "reads": n_batches * int(traffic["batch_reads"])
                      * int(traffic["ends"]),
                      "starved_s": starved, "t_closed": time.monotonic()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
