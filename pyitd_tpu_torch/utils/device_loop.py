"""Data-dependent loops as device state machines.

JAX runs FABADA's and SVMD's loops as ``lax.while_loop``s on the device.
Here the loop's state is a dict of tensors that stays on the device, and
:func:`run_until` applies the loop body ``block`` times between host reads
of the stop flag.  A step taken after the stop leaves every entry bitwise
unchanged (``torch.where`` on the flag), so the result is the while loop's
for any ``block``; ``block=1`` is the per-iteration eager loop.

On a CUDA state the block is captured once in a ``torch.cuda.CUDAGraph``
and replayed: the same kernels on the same inputs, so the same bits as the
eager block, for one launch per block instead of one per ATen call.  A
capture that fails raises; nothing falls back to the eager loop.  The
eager block is the CPU path (``GRAPHS = False`` makes it the CUDA path
too, for comparisons).

``RUNS`` records every loop since :func:`reset_runs`: the steps applied
(stopped steps included), the host reads and whether a graph ran, for the
smoke run's counts.
"""
from __future__ import annotations

import torch

__all__ = ["GRAPHS", "RUNS", "reset_runs", "run_until"]

GRAPHS = True
RUNS: list[dict] = []


def reset_runs() -> None:
    RUNS.clear()


def _block(step, state: dict, block: int, done: str) -> dict:
    for _ in range(block):
        stop = state[done]
        new = step(state)
        state = {k: torch.where(stop, v, new[k]) for k, v in state.items()}
    return state


def _graphed(step, state: dict, block: int, done: str):
    """A graph whose replay advances ``static`` (a copy of ``state``) in
    place by one block."""
    static = {k: v.clone() for k, v in state.items()}

    def advance():
        for k, v in _block(step, static, block, done).items():
            static[k].copy_(v)

    # warm up outside the capture (library handles, allocator), then undo
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        advance()
        for k, v in state.items():
            static[k].copy_(v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        advance()
    return graph, static


def run_until(step, state: dict, *, block: int, done: str = "done") -> dict:
    """Apply ``step`` (state dict -> new state dict) until ``state[done]``
    holds, reading the flag once per ``block`` steps."""
    graph = None
    if GRAPHS and state[done].is_cuda:
        graph, state = _graphed(step, state, block, done)
    steps = reads = 0
    while True:
        if graph is None:
            state = _block(step, state, block, done)
        else:
            graph.replay()
        steps += block
        reads += 1
        if bool(state[done]):
            RUNS.append({"steps": steps, "reads": reads,
                         "graph": graph is not None})
            return state
