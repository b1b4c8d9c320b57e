"""Host input pipeline: threaded readers, and batches copied to the card
ahead of the step (counterpart of ``deepcam_tpu/data/pipeline.py``).

* ``DataLoader`` reads and normalizes samples on a thread pool (h5py and the
  native routines release the GIL) and assembles each batch with the native
  parallel copy.  Batch order follows the dataset's order whatever order
  the threads finish in: futures are consumed in submission order.  With
  ``pin_memory`` the batch is assembled straight into page-locked memory,
  so its copy to the card needs no staging copy.
* ``prefetch_to_device`` keeps ``depth`` batches in flight to the card:
  each is copied with ``non_blocking=True`` on a side CUDA stream and
  records an event there, which the compute stream waits on before the
  step reads the batch.

Host spans (``profiling/spans.py``): ``data.read`` around each sample's
read on a reader thread, ``data.wait`` where the consumer blocks on the
readers, ``data.stage`` around a batch's assembly and around its queued
copy to the card.

Ordering: like the reference loader (no sampler, shuffle=False), batches
follow the dataset's construction-time order, and ``drop_last`` drops the
trailing partial batch.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Iterator, Tuple

import numpy as np
import torch

from ..ops import native
from ..profiling.spans import span


class DataLoader:
    """Ordered, read-ahead batch loader over a map-style dataset.

    Yields ``(data, label, names)``: ``data`` a (B, H, W, C) fp32 tensor, or
    bf16 when the dataset emits bf16; ``label`` (B, H, W) int32; ``names``
    the samples' file names.  All on the CPU, page-locked with
    ``pin_memory``.  An exception in a reader thread is raised here.
    """

    READ_AHEAD = 2  # batches whose reads are in flight beyond the next

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 drop_last: bool = True, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.pin_memory = pin_memory

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self):
        n = len(self.dataset)
        batches = [list(range(i, min(i + self.batch_size, n)))
                   for i in range(0, n, self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def _read(self, index):
        with span("data.read"):
            return self.dataset[index]

    def _assemble(self, samples) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
        arrays = [s[0] for s in samples]
        a0 = arrays[0]
        bf16 = a0.dtype == np.uint16  # bf16 bit patterns (CamDataset bf16_out)
        host_dtype = np.dtype(np.int16) if bf16 else a0.dtype
        if self.pin_memory:
            data = torch.empty((len(arrays),) + a0.shape, pin_memory=True,
                               dtype=torch.from_numpy(np.empty(0, host_dtype)).dtype)
            native.stack_samples(arrays, out=data.numpy().view(a0.dtype))
        else:
            data = torch.from_numpy(native.stack_samples(arrays).view(host_dtype))
        if bf16:
            data = data.view(torch.bfloat16)
        label = torch.from_numpy(np.stack([s[1] for s in samples]).astype(np.int32))
        if self.pin_memory:
            label = label.pin_memory()
        return data, label, tuple(s[2] for s in samples)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, tuple]]:
        batches = self._batch_indices()
        if not batches:
            return
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = collections.deque(
                [pool.submit(self._read, i) for i in b]
                for b in batches[:self.READ_AHEAD + 1])
            next_submit = len(pending)
            try:
                while pending:
                    with span("data.wait"):
                        samples = [f.result() for f in pending.popleft()]
                    if next_submit < len(batches):
                        pending.append([pool.submit(self._read, i)
                                        for i in batches[next_submit]])
                        next_submit += 1
                    with span("data.stage"):
                        batch = self._assemble(samples)
                    yield batch
            finally:
                for futures in pending:  # a consumer that stops early
                    for f in futures:
                        f.cancel()


def prefetch_to_device(iterator, device, depth: int = 2):
    """Yields the items of ``iterator`` (tuples whose tensors are host
    batches) with every tensor moved to ``device``, up to ``depth`` items
    ahead of the consumer.  Other elements (the names) pass through.

    On a CUDA device each item's tensors are copied with
    ``non_blocking=True`` on a side stream, from page-locked memory (pinned
    here unless the loader pinned them), and an event recorded after the
    copies; the consumer's current stream waits on that event before the
    item is yielded, and each device tensor is marked as used by that stream
    (``record_stream``), so its memory is not reused while the step may
    still read it.  The host buffers are held until their event has passed.
    On the CPU this is a plain in-order pass-through.
    """
    device = torch.device(device)
    if device.type != "cuda":
        yield from iterator
        return
    copy_stream = torch.cuda.Stream(device=device)
    in_flight = collections.deque()  # (device item, event)
    held = collections.deque()       # (event, host tensors) not yet known done

    def put(item):
        with span("data.stage"):
            host = [el if not isinstance(el, torch.Tensor) or el.is_pinned()
                    else el.pin_memory() for el in item]
            with torch.cuda.stream(copy_stream):
                moved = tuple(el.to(device, non_blocking=True) if isinstance(el, torch.Tensor)
                              else el for el in host)
                event = torch.cuda.Event()
                event.record(copy_stream)
        in_flight.append((moved, event))
        held.append((event, [el for el in host if isinstance(el, torch.Tensor)]))

    it = iter(iterator)
    try:
        for item in it:
            put(item)
            if len(in_flight) >= depth:
                break
        while in_flight:
            moved, event = in_flight.popleft()
            compute = torch.cuda.current_stream(device)
            compute.wait_event(event)
            for el in moved:
                if isinstance(el, torch.Tensor):
                    el.record_stream(compute)
            nxt = next(it, None)
            if nxt is not None:
                put(nxt)
            while held and held[0][0].query():
                held.popleft()
            yield moved
    finally:
        for event, _ in held:
            event.synchronize()
        held.clear()
        if hasattr(it, "close"):  # stops the loader's readers
            it.close()
