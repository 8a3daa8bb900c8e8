"""Traffic kind `resident`: frames already in device memory, classified
in place by a closed loop.

Mix parameters: `pool_batches` distinct batches of `batch` int8 frames
(levels, as a GPU decoder would leave them centred), made on the device
from the seed; `in_flight` batches launched ahead of the oldest fetch;
`route` of the engine. Each batch goes through
`InferenceEngine.launch_prepared(xd, argmax=True)` and its class indices
come back through `engine.fetch`. The window cycles the pool in order.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Inputs:
    frames: torch.Tensor              # int8 [P, B, H, W, C]


def inputs(ctx) -> Inputs:
    p = ctx.params
    shape = (p["pool_batches"], p["batch"]) + \
        tuple(ctx.cell.config["input_shape"])
    frames = torch.randint(-128, 128, shape, dtype=torch.int8,
                           device=ctx.device, generator=ctx.generator)
    return Inputs(frames)


def setup(ctx, inp: Inputs):
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    eng = InferenceEngine.from_artifact(ctx.artifact, device=ctx.device,
                                        route=ctx.params["route"])
    eng.fetch(eng.launch_prepared(inp.frames[0], argmax=True))
    if ctx.fault is not None:
        ctx.fault(eng)
    return {"engine": eng}


def window(state, inp: Inputs, ctx, tr):
    from portbench.harness import Window
    eng = state["engine"]
    frames = inp.frames
    npool, batch = frames.shape[0], frames.shape[1]
    depth = ctx.params["in_flight"]
    served = [[] for _ in range(npool)]
    pending = deque()
    t0 = tr.start_window()
    deadline = t0 + ctx.seconds
    slice_at = deadline - tr.slice_s
    i = 0
    while True:
        now = time.perf_counter()
        if now >= tr.deadline(deadline):
            break
        if tr.enabled and now >= slice_at:
            tr.begin_slice()
        b = i % npool
        with tr.span("pb.launch"):
            pending.append((b, eng.launch_prepared(frames[b], argmax=True)))
        tr.count("forwards")
        tr.count("images", batch)
        i += 1
        if len(pending) >= depth:
            b, out = pending.popleft()
            with tr.span("pb.fetch"):
                served[b].append(eng.fetch(out))
    while pending:
        b, out = pending.popleft()
        with tr.span("pb.fetch"):
            served[b].append(eng.fetch(out))
    t1 = time.perf_counter()
    tr.end_slice()
    answers = []
    for b, outs in enumerate(served):
        if outs:
            ids = np.tile(np.arange(b * batch, (b + 1) * batch), len(outs))
            answers.append((ids, np.concatenate(outs)))
    return Window(seconds=t1 - t0, images=i * batch, attempted=i * batch,
                  failed=0, answers=answers)


def release(state) -> None:
    state.clear()


def reference_inputs(inp: Inputs) -> torch.Tensor:
    f = inp.frames
    return f.reshape((-1,) + tuple(f.shape[2:]))
