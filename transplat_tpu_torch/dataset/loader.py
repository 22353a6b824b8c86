"""Host data loading: batching with a prefetch thread or forked worker
processes, the synthetic and golden-scene batches (numpy only), and the move
of a batch to a device.

Own copies of `_stack_examples`, `DataLoader`, `MultiWorkerLoader`,
`synthetic_batch`, `_plane_texture` and `golden_scene_batch` from
transplat_tpu/dataset/loader.py, so the port needs nothing of the JAX
package; the arrays are equal bit for bit (tests/test_torch_fit_eval.py,
tests/test_torch_dataset.py). Where the JAX loaders can wait forever, these
raise: a worker's error reaches the consumer."""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


# The encoder's inputs, in the order of its forward's arguments.
CONTEXT_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")


def batch_to_device(batch: dict, device) -> dict:
    """The context and target views of a batch (numpy arrays or tensors) as
    float32 tensors on `device`; the view indices and scene names stay behind."""
    return {
        side: {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in batch[side].items() if k != "index"}
        for side in ("context", "target")
    }


def _stack_examples(examples: list) -> dict:
    def stack_views(key):
        views = [e[key] for e in examples]
        return {
            k: np.stack([v[k] for v in views]) for k in views[0] if k != "index"
        } | {"index": np.stack([np.asarray(v["index"]) for v in views])}

    return {
        "context": stack_views("context"),
        "target": stack_views("target"),
        "scene": [e["scene"] for e in examples],
    }


class DataLoader:
    """Batches an example iterator with background prefetch (a thread). An
    error of the iterator reaches the consumer; closing the consumer's
    iterator stops the thread."""

    def __init__(self, dataset, batch_size: int, prefetch: int = 4, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            buf = []
            try:
                for example in self.dataset:
                    buf.append(example)
                    if len(buf) == self.batch_size:
                        if not put(("batch", _stack_examples(buf))):
                            return
                        buf = []
                if buf and not self.drop_last:
                    put(("batch", _stack_examples(buf)))
                put(("done", None))
            except Exception as e:  # handed to the consumer, which raises it
                put(("error", e))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "error":
                    raise item
                if kind == "done":
                    break
                yield item
        finally:
            stop.set()


class MultiWorkerLoader:
    """Batches from forked worker processes through one shared queue.

    `make_worker_iter(worker_id)` -> an iterable of examples; each worker
    assembles whole batches from its own shard and pushes them (batch order
    across workers is not deterministic). Forked workers inherit the
    factory's closure, so state they must see change (the curriculum's step)
    is shared explicitly: a multiprocessing.Value read inside the closure.

    The workers fork from a process that may hold a CUDA context: they must
    touch nothing on the card (numpy, torch.load of CPU tensors and the host
    decoder only). `finish`, if given, runs in the consuming process on each
    example the workers send, before the batch is stacked (the card's JPEG
    decoder). A worker that raises or dies ends the iteration with a
    RuntimeError (with its traceback). A worker whose iterable ends sends a
    sentinel: with `finite` (one pass each) the iteration ends after every
    worker's; without it (endless workers) the end of all of them raises."""

    def __init__(
        self,
        make_worker_iter,
        num_workers: int,
        batch_size: int,
        prefetch: int = 4,
        finite: bool = False,
        finish=None,
    ):
        self.make_worker_iter = make_worker_iter
        self.num_workers = max(1, num_workers)
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.finite = finite
        self.finish = finish

    def _worker(self, worker_id: int, q) -> None:
        import traceback

        buf = []
        try:
            for example in self.make_worker_iter(worker_id):
                buf.append(example)
                if len(buf) == self.batch_size:
                    q.put(("batch", buf if self.finish is not None else _stack_examples(buf)))
                    buf = []
            q.put(("done", worker_id))
        except Exception:
            q.put(("error", f"loader worker {worker_id} failed:\n{traceback.format_exc()}"))

    def __iter__(self) -> Iterator[dict]:
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        q = ctx.Queue(maxsize=self.prefetch * self.num_workers)
        procs = [ctx.Process(target=self._worker, args=(w, q), daemon=True) for w in range(self.num_workers)]
        for p in procs:
            p.start()
        done = 0
        try:
            while done < self.num_workers:
                try:
                    kind, item = q.get(timeout=5.0)
                except queue.Empty:
                    killed = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    if killed:
                        raise RuntimeError(f"loader workers (id, exit code) {killed} died without a word") from None
                    continue
                if kind == "error":
                    raise RuntimeError(item)
                if kind == "done":
                    done += 1
                    if self.finite:
                        continue
                    if done == self.num_workers:
                        raise RuntimeError(f"all {self.num_workers} loader workers ended: their examples ran out")
                    continue
                yield _stack_examples([self.finish(e) for e in item]) if self.finish is not None else item
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=2)


def synthetic_batch(
    key: int = 0,
    batch_size: int = 1,
    num_context: int = 2,
    num_target: int = 2,
    image_shape: tuple[int, int] = (256, 256),
    near: float = 1.0,
    far: float = 100.0,
) -> dict:
    """Random posed batch for tests/benchmarks (no dataset required)."""
    rng = np.random.default_rng(key)
    h, w = image_shape

    def views(v):
        intr = np.tile(
            np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], np.float32),
            (batch_size, v, 1, 1),
        )
        extr = np.tile(np.eye(4, dtype=np.float32), (batch_size, v, 1, 1))
        for i in range(v):
            extr[:, i, 0, 3] = 0.25 * i + 0.05 * rng.standard_normal(batch_size)
            extr[:, i, 1, 3] = 0.02 * rng.standard_normal(batch_size)
        return {
            "image": rng.random((batch_size, v, h, w, 3), np.float32),
            "intrinsics": intr,
            "extrinsics": extr,
            "near": np.full((batch_size, v), near, np.float32),
            "far": np.full((batch_size, v), far, np.float32),
            "index": np.tile(np.arange(v), (batch_size, 1)),
        }

    return {
        "context": views(num_context),
        "target": views(num_target),
        "scene": [f"synthetic_{i}" for i in range(batch_size)],
    }


def _plane_texture(k: int, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Smooth procedural RGB texture for plane k, evaluated at world (x, y)."""
    base = np.array(
        [
            [0.85, 0.35, 0.30],
            [0.30, 0.75, 0.40],
            [0.30, 0.45, 0.90],
            [0.85, 0.80, 0.30],
        ],
        np.float32,
    )[k % 4]
    f = 2.0 + 1.5 * k
    tex = (
        0.5
        + 0.25 * np.sin(f * x + 0.7 * k)[..., None] * np.cos((f + 1.0) * y)[..., None]
        + 0.15 * np.sin((2.3 * f) * (x + y) + k)[..., None]
    )
    return np.clip(tex * base, 0.0, 1.0).astype(np.float32)


def golden_scene_batch(
    num_context: int = 2,
    num_target: int = 4,
    image_shape: tuple[int, int] = (256, 256),
    near: float = 1.0,
    far: float = 100.0,
) -> dict:
    """Deterministic parallax-consistent golden scene (batch of 1).

    Textured fronto-parallel planes at mixed depths with finite extents, so
    views see real parallax AND occlusion edges: the geometrically
    structured stand-in for a real RE10K scene used by the overfit
    regression gate (overfit_golden.py, tests/test_torch_fit_eval.py).

    Planes (depth, x-extent, y-extent): a far backdrop plus mid/near cards.
    Cameras: small x-baseline translations, identity rotation (matches the
    posed-pair geometry of synthetic_batch).
    """
    h, w = image_shape
    planes = [
        (12.0, None, None),  # backdrop (infinite)
        (6.0, (-2.2, 0.8), (-1.8, 1.8)),
        (3.5, (-0.2, 1.6), (-1.2, 1.0)),
        (2.2, (-1.0, 0.1), (-0.3, 0.9)),
    ]

    def render_view(extr: np.ndarray) -> np.ndarray:
        fx = fy = 1.0 * w  # normalized intr 1.0 -> pixels
        u = (np.arange(w, dtype=np.float32) + 0.5) / w
        v = (np.arange(h, dtype=np.float32) + 0.5) / h
        uu, vv = np.meshgrid(u, v, indexing="xy")
        d = np.stack([(uu - 0.5), (vv - 0.5), np.ones_like(uu)], axis=-1)
        rot = extr[:3, :3]
        t = extr[:3, 3]
        dirs = d @ rot.T
        img = np.zeros((h, w, 3), np.float32)
        depth_hit = np.full((h, w), np.inf, np.float32)
        for k, (dz, xe, ye) in enumerate(planes):
            s = (dz - t[2]) / dirs[..., 2]
            px = t[0] + s * dirs[..., 0]
            py = t[1] + s * dirs[..., 1]
            hit = s > 0
            if xe is not None:
                hit &= (px >= xe[0]) & (px <= xe[1])
            if ye is not None:
                hit &= (py >= ye[0]) & (py <= ye[1])
            hit &= s < depth_hit
            tex = _plane_texture(k, px, py)
            img = np.where(hit[..., None], tex, img)
            depth_hit = np.where(hit, s, depth_hit)
        return img

    def views(offsets):
        nv = len(offsets)
        intr = np.tile(
            np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], np.float32),
            (1, nv, 1, 1),
        )
        extr = np.tile(np.eye(4, dtype=np.float32), (1, nv, 1, 1))
        images = np.zeros((1, nv, h, w, 3), np.float32)
        for i, (ox, oy) in enumerate(offsets):
            extr[0, i, 0, 3] = ox
            extr[0, i, 1, 3] = oy
            images[0, i] = render_view(extr[0, i])
        return {
            "image": images,
            "intrinsics": intr,
            "extrinsics": extr,
            "near": np.full((1, nv), near, np.float32),
            "far": np.full((1, nv), far, np.float32),
            "index": np.tile(np.arange(nv), (1, 1)),
        }

    ctx_offsets = [(-0.25 + 0.5 * i / max(num_context - 1, 1), 0.0) for i in range(num_context)]
    tgt_offsets = [
        (-0.2 + 0.4 * i / max(num_target - 1, 1), 0.03 * ((-1) ** i))
        for i in range(num_target)
    ]
    return {
        "context": views(ctx_offsets),
        "target": views(tgt_offsets),
        "scene": ["golden_planes"],
    }
