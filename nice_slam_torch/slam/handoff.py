"""Hand-offs of shared device data between the threads of the loose and
free schedules.

Under loose and free sync the tracker, the mapper and the coarse mapper
are host threads, each issuing its device work on streams of its own, one
on every card in use (the thread makes each current on its card).  They
share the scene state, the pose list and the keyframe store.  A
``Handoff`` guards one of them: a lock, and per stream the CUDA event
recorded after that stream's last access.  An access holds the lock, makes
the calling thread's current stream on every card wait for the last
access of every other stream (``cudaStreamWaitEvent`` takes an event
recorded on another card, so a read on one card waits for a write made on
another), runs, and records an event on each of its own streams.  So a
reader never runs ahead of a write that was issued before it took the
lock, and a write is ordered after every read issued before it: a read
never sees a value half written.

The caching allocator ties a freed block to the stream that allocated
it and may hand it to that stream's next allocation while another stream
still reads it.  So a thread that reads tensors another stream made marks
them with ``hold`` (``Tensor.record_stream``, on the current stream of the
tensor's own card): the allocator then waits for the reader's work there
before it reuses the block.  This keeps the bookkeeping with the reader,
which alone knows what it still reads.  (A writer that drops a tensor its
own queued work still reads, made on another stream, holds it the same
way.)

On the CPU there are no streams, and the lock alone orders the threads.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterable, Iterator, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device]


def cuda_cards(devices: Sequence[DeviceLike]) -> list:
    """The distinct CUDA devices of a device list, in index order."""
    cards = {torch.device(d) for d in devices}
    cards = {torch.device("cuda", torch.cuda.current_device())
             if d.index is None else d for d in cards if d.type == "cuda"}
    return sorted(cards, key=lambda d: d.index)


class Handoff:
    """A lock plus the event of each CUDA stream's last access, over the
    cards of ``devices`` (one device or a list)."""

    def __init__(self, devices: Union[DeviceLike, Sequence[DeviceLike]]):
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.lock = threading.RLock()
        self.cards = cuda_cards(devices)
        # (card index, stream handle) -> event of that stream's last access
        self._events: Dict[Tuple[int, int], torch.cuda.Event] = {}

    @contextlib.contextmanager
    def access(self) -> Iterator[None]:
        with self.lock:
            if not self.cards:
                yield
                return
            mine = [torch.cuda.current_stream(c) for c in self.cards]
            keys = {(s.device_index, s.cuda_stream) for s in mine}
            for stream in mine:
                for key, event in self._events.items():
                    if key not in keys:
                        stream.wait_event(event)
            yield
            for stream in mine:
                event = torch.cuda.Event()
                event.record(stream)
                self._events[(stream.device_index, stream.cuda_stream)] = event


def hold(tensors: Iterable[torch.Tensor]) -> None:
    """Mark CUDA tensors made on another stream as in use by the current
    stream of their own card, so their memory is not reused before its
    work is done."""
    streams: Dict[torch.device, torch.cuda.Stream] = {}
    for t in tensors:
        if t.is_cuda:
            if t.device not in streams:
                streams[t.device] = torch.cuda.current_stream(t.device)
            t.record_stream(streams[t.device])
