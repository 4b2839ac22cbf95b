"""Spans around calls into the port's modules, from the benchmark's side.

A per-layer metric names the modules it wants timed (a module path, or a
predicate on the path and the module); :class:`Spans` hooks exactly those,
records a CUDA event (the host clock on the CPU) before and after each
forward call and, in train cells where a metric asks for it, around each
call's backward pass through full backward hooks, with the call's shapes.
Nothing is read until :meth:`Spans.calls`, after the device has finished.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

_TRANSPOSED = (torch.nn.ConvTranspose1d, torch.nn.ConvTranspose2d,
               torch.nn.ConvTranspose3d)
Selector = str | Callable[[str, torch.nn.Module], bool]


class _Mark:
    """A point on the device's timeline: a CUDA event, or the host clock
    on the CPU (where a call has ended when it returns)."""

    def __init__(self, cuda: bool):
        if cuda:
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.event = None
            self.time = time.perf_counter()

    def ms_until(self, other: "_Mark") -> float:
        if self.event is not None:
            return self.event.elapsed_time(other.event)
        return (other.time - self.time) * 1e3


def _shape(value):
    return tuple(value.shape) if isinstance(value, torch.Tensor) else None


def _dtype_name(value) -> str:
    return str(value.dtype).removeprefix("torch.")


class Spans:
    """Hooks on the modules of ``network`` that ``requests`` select."""

    def __init__(self, network: torch.nn.Module,
                 requests: dict[str, tuple[Selector, bool]], cuda: bool):
        """``requests``: span name -> (selector, with backward)."""
        self._cuda = cuda
        self._handles = []
        self._calls: dict[str, list[dict]] = {name: [] for name in requests}
        for name, (selector, backward) in requests.items():
            for path, module in network.named_modules():
                chosen = (path == selector if isinstance(selector, str)
                          else selector(path, module))
                if chosen:
                    self._hook(name, path, module, backward)

    def _hook(self, name: str, path: str, module: torch.nn.Module,
              backward: bool) -> None:
        calls = self._calls[name]
        pending_backward = []

        def before(_module, inputs):
            calls.append({"path": path, "start": _Mark(self._cuda),
                          "input_shape": _shape(inputs[0]),
                          "dtype": _dtype_name(inputs[0])})

        def after(_module, _inputs, output):
            call = calls[-1]
            call["end"] = _Mark(self._cuda)
            call["output_shape"] = _shape(output)
            weight = getattr(module, "weight", None)
            call["weight_shape"] = _shape(weight)
            call["stride"] = getattr(module, "stride", None)
            call["padding"] = getattr(module, "padding", None)
            call["transposed"] = isinstance(module, _TRANSPOSED)
            pending_backward.append(call)

        # Backward passes run in the reverse order of the forward calls.
        def backward_before(_module, _grad_output):
            pending_backward[-1]["backward_start"] = _Mark(self._cuda)

        def backward_after(_module, _grad_input, _grad_output):
            pending_backward.pop()["backward_end"] = _Mark(self._cuda)

        self._handles.append(module.register_forward_pre_hook(before))
        self._handles.append(module.register_forward_hook(after))
        if backward:
            self._handles.append(
                module.register_full_backward_pre_hook(backward_before))
            self._handles.append(
                module.register_full_backward_hook(backward_after))

    def remove(self) -> None:
        for handle in self._handles:
            handle.remove()
        self._handles = []

    def calls(self) -> dict[str, list[dict]]:
        """Per span name, one dict per call: ``forward_ms`` (and
        ``backward_ms`` where hooked), the input, weight and output
        shapes, stride, padding, whether transposed, the input's dtype.
        Call after the device has finished."""
        result = {}
        for name, calls in self._calls.items():
            result[name] = []
            for call in calls:
                record = {key: value for key, value in call.items()
                          if not isinstance(value, _Mark)}
                record["forward_ms"] = call["start"].ms_until(call["end"])
                if "backward_end" in call:
                    record["backward_ms"] = call["backward_start"].ms_until(
                        call["backward_end"])
                result[name].append(record)
        return result
