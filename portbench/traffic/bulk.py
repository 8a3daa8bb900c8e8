"""Traffic kind `bulk`: uint8 images in host memory labelled offline by a
closed loop through the public `Classifier.classify_images`.

Mix parameters: `pool_batches` distinct batches of `batch` uint8 images,
made from the seed on the device and copied to (pageable) host memory in
set-up; `route` of the engine. The window cycles the pool in order, one
call at a time; the class indices come back in host memory.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Inputs:
    images: np.ndarray                # uint8 [P, B, H, W, C], host


def inputs(ctx) -> Inputs:
    p = ctx.params
    shape = (p["pool_batches"], p["batch"]) + \
        tuple(ctx.cell.config["input_shape"])
    imgs = torch.randint(0, 256, shape, dtype=torch.uint8,
                         device=ctx.device, generator=ctx.generator)
    return Inputs(imgs.cpu().numpy())


def setup(ctx, inp: Inputs):
    from bnn_pynq_tpu_torch.runtime.classifier import Classifier
    clf = Classifier.from_artifact(ctx.artifact, device=ctx.device,
                                   route=ctx.params["route"])
    clf.classify_images(inp.images[0])
    if ctx.fault is not None:
        ctx.fault(clf.engine)
    return {"classifier": clf}


def window(state, inp: Inputs, ctx, tr):
    from portbench.harness import Window
    clf = state["classifier"]
    pool = inp.images
    npool, batch = pool.shape[0], pool.shape[1]
    served = [[] for _ in range(npool)]
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
        with tr.span("pb.classify_images"):
            served[b].append(clf.classify_images(pool[b]))
        tr.count("images", batch)
        i += 1
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
    x = torch.from_numpy(inp.images)
    return x.reshape((-1,) + tuple(x.shape[2:]))
