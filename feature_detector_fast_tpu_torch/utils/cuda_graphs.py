"""One CUDA graph a device for a solver's calls of one shape.

A solver (``posegraph.optimize``, ``ba.optimize``) keys each call on CUDA
tensors by its device, its inputs' devices, dtypes and shapes and its other
arguments.  ``Graphs.run`` captures a graph of the call where its key has
come ``CAPTURE_AT`` times in a row on a device, in place of the device's
graph, and answers that call and later calls of the key by a replay: their
inputs copied into the graph's static buffers, clones of its outputs
returned.  Any other call runs eagerly.  Each solver keeps a ``Graphs`` of
its own, so that solvers whose calls alternate each keep their graph.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence, Tuple

import torch

#: The call of one key, counted in a row on a device, that captures its
#: graph.  The tools run a key twice (warm-up and timed run), a loop graph's
#: key comes once, and a capture costs about two eager calls: from the
#: third call on, a key is one that a stream of problems repeats.
CAPTURE_AT = 3


class Device:
    """A device's CUDA graph: the key of its previous call and how many
    calls in a row had it, the graph kept and its key, the side stream
    captures use, and the event of the last replay."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.done = torch.cuda.Event()
        self.last = self.key = self.graph = None
        self.run = 0


class Graph:
    """One call as a CUDA graph: ``run(inputs, warm)`` makes the call on a
    tuple of tensors, or with ``warm`` a one-step call of the same shapes;
    the graph keeps the static inputs it reads and the static outputs each
    replay overwrites."""

    def __init__(self, run: Callable[[tuple, bool], tuple], inputs: Sequence[torch.Tensor],
                 dev: Device):
        self.dev = dev
        self.inputs = tuple(t.clone() for t in inputs)
        caller = torch.cuda.current_stream(dev.stream.device)
        dev.stream.wait_stream(caller)
        # One step first on the capture stream, so that the capturing
        # thread's library handles exist before capture.  cuBLAS keeps a
        # workspace (32 MiB on Hopper) a handle and stream for the process's
        # life: cleared after the step and after the capture, the capture
        # stream's is allocated and freed inside the graph's own memory
        # pool, and the graph holds no allocation beyond its static buffers.
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(dev.stream):
            run(self.inputs, True)
            torch._C._cuda_clearCublasWorkspaces()
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.outputs = run(self.inputs, False)
            finally:
                self.graph.capture_end()
        torch._C._cuda_clearCublasWorkspaces()
        caller.wait_stream(dev.stream)

    def replay(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """Copy-in, replay and clone-out on the caller's stream, after the
        device's last replay, whichever stream that ran on."""
        stream = torch.cuda.current_stream(self.dev.stream.device)
        stream.wait_event(self.dev.done)
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        self.graph.replay()
        out = tuple(t.clone() for t in self.outputs)
        self.dev.done.record(stream)
        return out


class Graphs:
    """A solver's CUDA graphs, one a device.  One lock covers lookup,
    capture and replay: a graph's static buffers serve one call at a time."""

    def __init__(self):
        self.lock = threading.Lock()
        self.devices = {}

    def new_device(self, device: torch.device) -> Device:
        return Device(device)

    def run(self, key: tuple, inputs, make_graph: Callable[[Device], Graph]
            ) -> Optional[Tuple[tuple, bool]]:
        """(outputs, whether this call captured) of the call's replay, or
        None where the call runs eagerly: its key (``key[0]`` its device) is
        not the device's graph's, and has come fewer than ``CAPTURE_AT``
        times in a row.  ``make_graph(device)`` captures the call."""
        with self.lock:
            dev = self.devices.get(key[0])
            if dev is None:
                dev = self.devices[key[0]] = self.new_device(key[0])
            dev.run = dev.run + 1 if key == dev.last else 1
            dev.last = key
            captured = key != dev.key
            if captured:
                if dev.run < CAPTURE_AT:
                    return None
                if dev.graph is not None:
                    # Its last replay ends before its memory is freed.
                    dev.done.synchronize()
                    dev.key = dev.graph = None
                dev.graph, dev.key = make_graph(dev), key
            return dev.graph.replay(inputs), captured
