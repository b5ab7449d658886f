"""Hand-offs of shared device data between the threads of the loose and
free schedules.

Under loose and free sync the tracker, the mapper and the coarse mapper
are host threads, each issuing its device work on its own CUDA stream.
They share the scene state, the pose list and the keyframe store.  A
``Handoff`` guards one of them: a lock, and per stream the CUDA event
recorded after that stream's last access.  An access holds the lock, makes
the current stream wait for every other stream's last access, runs, and
records its own event.  So a reader's stream never runs ahead of a write
that was issued before it took the lock, and a write is ordered after
every read issued before it: a read never sees a value half written.

The caching allocator ties a freed block to the stream that allocated
it and may hand it to that stream's next allocation while another stream
still reads it.  So a thread that reads tensors another stream made marks
them with ``hold`` (``Tensor.record_stream``): the allocator then waits for
the reader's work before it reuses the block.  This keeps the bookkeeping
with the reader, which alone knows what it still reads.  (A writer that
drops a tensor its own queued work still reads, made on another stream,
holds it the same way.)

On the CPU there are no streams, and the lock alone orders the threads.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterable, Iterator

import torch


class Handoff:
    """A lock plus the event of each CUDA stream's last access."""

    def __init__(self, device):
        self.lock = threading.RLock()
        self.cuda = torch.device(device).type == "cuda"
        self._events: Dict[int, torch.cuda.Event] = {}

    @contextlib.contextmanager
    def access(self) -> Iterator[None]:
        with self.lock:
            if not self.cuda:
                yield
                return
            stream = torch.cuda.current_stream()
            me = stream.cuda_stream
            for sid, event in self._events.items():
                if sid != me:
                    stream.wait_event(event)
            yield
            event = torch.cuda.Event()
            event.record(stream)
            self._events[me] = event


def hold(tensors: Iterable[torch.Tensor]) -> None:
    """Mark CUDA tensors made on another stream as in use by the current
    one, so their memory is not reused before its work is done."""
    stream = None
    for t in tensors:
        if t.is_cuda:
            stream = stream or torch.cuda.current_stream()
            t.record_stream(stream)
