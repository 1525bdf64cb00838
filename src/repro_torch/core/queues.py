"""Sample queue between Actor and Trainer (the Redis stream of the paper's
implementation, collapsed to an in-process ring buffer with the same
back-pressure semantics: a bounded buffer that drops the *oldest* samples
keeps lag minimal when the trainer stalls, e.g. during a checkpoint). A
copy of the JAX package's `core/queues.py`."""
from __future__ import annotations

from collections import deque
from typing import List, Optional

from repro_torch.data.packing import Rollout


class QueueUnderflow(ValueError):
    """`pop(n)` asked for more rollouts than the queue holds. Carries the
    observed `depth` and the `requested` count so stage code can tell
    starvation (depth shrank under it — wait and re-kick) from a bug
    (requested more than the stage's own batch size). Subclasses
    ValueError so pre-existing handlers keep working."""

    def __init__(self, depth: int, requested: int):
        self.depth, self.requested = depth, requested
        super().__init__(f"queue has {depth} < {requested}")


class SampleQueue:
    def __init__(self, maxsize: Optional[int] = None):
        self.buf: deque = deque()
        self.maxsize = maxsize
        self.dropped = 0
        self.total_put = 0
        self.requeued = 0         # salvage re-insertions (recovery path)
        self.high_watermark = 0   # max depth seen (trainer-stall telemetry)

    def put(self, rollouts: List[Rollout]) -> None:
        for r in rollouts:
            self.buf.append(r)
            self.total_put += 1
            # sample depth BEFORE the drop: the intra-put peak (maxsize+1
            # while a drop is pending) is the telemetry that shows the
            # queue actually overflowed, not merely sat full
            self.high_watermark = max(self.high_watermark, len(self.buf))
            if self.maxsize is not None and len(self.buf) > self.maxsize:
                self.buf.popleft()  # ring-buffer semantics: drop oldest
                self.dropped += 1

    def requeue_front(self, rollouts: List[Rollout]) -> None:
        """Recovery path: put salvaged rollouts back at the FRONT of the
        queue in their original order (they are the oldest samples, so
        they must be the first ones the next pop sees and the first ones
        a drop-oldest overflow evicts). Does not inflate `total_put` —
        these samples were already counted when first produced; `requeued`
        tracks the salvage traffic separately. maxsize still holds: if
        re-insertion overflows the queue, the oldest (i.e. the salvaged)
        samples are dropped."""
        for r in reversed(rollouts):
            self.buf.appendleft(r)
            self.requeued += 1
            self.high_watermark = max(self.high_watermark, len(self.buf))
        while self.maxsize is not None and len(self.buf) > self.maxsize:
            self.buf.popleft()
            self.dropped += 1

    def pop(self, n: int) -> List[Rollout]:
        if len(self.buf) < n:
            raise QueueUnderflow(len(self.buf), n)
        return [self.buf.popleft() for _ in range(n)]

    def __len__(self) -> int:
        return len(self.buf)
