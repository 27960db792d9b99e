"""CUDA graphs of the trainers' steps: the port's counterpart of the JAX
package's scanned epochs.

The JAX package compiles a training epoch as ``lax.scan`` segments of
``steps_per_scan`` updates and a validation epoch as one ``jax.jit``, so
the host dispatches a segment, not each kernel. Here a segment is a CUDA
graph: its step bodies are captured once and replayed, and a replay
launches every kernel of the segment from the device's queue.

:class:`StepGraphs` holds one trainer's graphs, keyed by what they run (a
segment length, the validation epoch, a branch of the restricted final
layer), all in one private memory pool, with the trainer's device
generator registered with each, so that the graphed random draws are the
eager ones. ``run(key, body)``:

- on the CPU calls ``body()``: the eager body, the same Python that a
  capture records;
- on CUDA, the first run of a key calls ``body()`` eagerly on a side
  stream. That warm-up is real work (the first update or updates of an
  epoch, the first validation epoch): it loads every kernel library and
  module the body launches and creates the optimizer's state before any
  capture, and it leaves the trajectory as it was. The second run captures
  ``body`` on the same side stream and replays it, and every later run
  replays it. A run returns what ``body`` returned when it last ran in
  Python (at the warm-up, then at the capture): a replay rewrites those
  tensors in place.

A failed capture or replay raises. A body reads its inputs from tensors
that live across replays (parameters, optimizer state, an epoch's batch
indices on the device, a step counter that the body advances) and writes
its results into such tensors: nothing that the host passes at a call
reaches a replay.

While the recorder of ``utils/telemetry`` is on (a ``torch.profiler`` is
recording, or a ``recording()`` scope is open), each run on CUDA is a span
named for what it does, ``graphs.warmup`` or ``graphs.replay``, and a pair
of CUDA events on the current stream brackets its device work
(``telemetry.graph_run``): a warm-up from before the side stream waits on
the current one to after the current one waits on the side stream, a
replay (the one after a capture included) around ``graph.replay()``. A
capture is host work the device waits on, the span ``graphs.capture``.
``telemetry.recorded()`` turns them into each run's device time and the
gaps between runs. Off, a run costs one check.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

import torch

from primekg_rgcn_tpu_torch.utils import telemetry

# Work per replay when TrainConfig.steps_per_scan is 0, picked on one H100
# (NVIDIA H100 80GB HBM3, 700 W; scripts/port_graphed_phases.py, phases
# train_graphed and sampled_train_graphed) from K in {1, 4, 32}: on the
# bench.py graph the full-graph update took 2.888 / 2.882 / 2.915 ms
# (device busy 2.78) and peaked at 239 / 303 / 368 MB, the block-mode
# sampled step 5.114 / 5.111 / 5.109 ms (busy 4.97) at 524 / 589 / 652 MB.
# The step times tie within 1.2 %; K = 1 holds the least memory, one graph
# and the shortest warm-up. Both trainers take it.
DEFAULT_STEPS_PER_GRAPH = 1


def steps_per_graph(steps_per_scan: int) -> int:
    """The steps (optimizer updates of the full-graph trainer, steps of the
    one-device sampled trainer) per captured segment."""
    return int(steps_per_scan) if steps_per_scan > 0 else \
        DEFAULT_STEPS_PER_GRAPH


class StepGraphs:
    """The captured step bodies of one trainer on ``device``, sharing one
    private memory pool; ``generator`` (the trainer's device generator) is
    registered with every graph. See the module docstring.

    ``captures``, ``replays``, ``warmups`` and ``capture_s`` count what the
    runs did."""

    def __init__(self, device, generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        self.generator = generator
        self._graphs: Dict[Hashable, Tuple[Any, Any]] = {}
        self._warm: set = set()
        self.captures = self.replays = self.warmups = 0
        self.capture_s = 0.0
        self._pool = self._stream = None
        if self.graphed:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)

    @property
    def graphed(self) -> bool:
        """Whether runs capture and replay (the device is CUDA)."""
        return self.device.type == "cuda"

    def run(self, key: Hashable, body: Callable[[], Any]) -> Any:
        """``body()``, eagerly on the CPU; on CUDA the warm-up, the capture
        or a replay of ``key``'s graph."""
        if not self.graphed:
            return body()
        entry = self._graphs.get(key)
        kind = "replay"
        if entry is None:
            if key not in self._warm:
                self._warm.add(key)
                self.warmups += 1
                with telemetry.graph_run("graphs.warmup", key, "warmup",
                                         self.device):
                    return self._on_side_stream(body)
            kind = "capture"
            with telemetry.span("graphs.capture", wait=True):
                entry = self._graphs[key] = self._capture(body)
        graph, out = entry
        with telemetry.graph_run("graphs.replay", key, kind, self.device):
            graph.replay()
        self.replays += 1
        return out

    def reset(self) -> None:
        """Drop every graph: the next run of a key captures it again. Call
        it when a tensor a graph reads is replaced (an optimizer's
        ``load_state_dict``)."""
        self._graphs.clear()

    def _on_side_stream(self, body):
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            out = body()
        main.wait_stream(self._stream)
        return out

    def _capture(self, body):
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    f"torch {torch.__version__} cannot register a generator "
                    "with a CUDA graph (CUDAGraph.register_generator_state)")
            graph.register_generator_state(self.generator)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            out = body()
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        return graph, out


def run_segments(graphs: Optional[StepGraphs], tag: str,
                 body: Callable[[], Any], n: int, k: int) -> None:
    """``body`` (one optimizer update) ``n`` times: ``n // k`` runs of a
    ``k``-body segment, then one segment of the remaining ``n % k`` (the
    JAX package's full and remainder scan segments). Each segment is one
    graph key, ``(tag, length)``, and a ``train.update`` span of ``length``
    updates; with ``graphs`` None every body runs eagerly."""
    k = max(1, min(int(k), n))

    def segment(length):
        def run():
            for _ in range(length):
                body()
        return run

    for length in [k] * (n // k) + ([n % k] if n % k else []):
        if graphs is None:
            segment(length)()
        else:
            with telemetry.span("train.update", updates=length):
                graphs.run((tag, length), segment(length))
