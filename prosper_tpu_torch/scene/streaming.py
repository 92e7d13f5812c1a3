"""Asynchronous asset streaming: the DeferredLoadingContext analog.

A copy of prosper_tpu/scene/streaming.py. The reference's loading
worker (DeferredLoadingContext.cpp loadingWorker :1031-1054) loads all
meshes first, then all textures; the main thread polls once a frame and
adopts what finished (WorldData::pollMeshWorker/pollTextureWorker).
Meshes not yet loaded keep tri_count 0 and degenerate (zero) triangles,
so rays cannot hit them and the culler skips them, the meshletCount == 0
gate of draw_list_generator.comp:38-41.

The worker thread does the host work only (mesh processing, image
decoding and mips) and hands numpy arrays over a queue. `poll` adopts at
most a budget a frame and never blocks. The caller writes the adopted
data into its device tensors on the main thread, between frames
(scene/world.py `World.poll_streaming`, scene/textures.py `arena_write`).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

MAX_ADOPTIONS_PER_FRAME = 10  # <= 10 builds a frame (World.cpp:556)


@dataclass
class LoadedMesh:
    mesh_index: int
    arrays: dict  # processed MeshData arrays (clusters, arena slices)


@dataclass
class LoadedTexture:
    image_index: int
    offset: int  # quad-arena row offset of the texture's mip chain
    chunk: np.ndarray  # (rows, 4) u32 packed quads, all mips contiguous


class StreamingContext:
    """Background loader with per-frame adoption."""

    def __init__(self, mesh_jobs, texture_jobs) -> None:
        """mesh_jobs, texture_jobs: lists of zero-argument callables
        returning a LoadedMesh or a LoadedTexture (made by World and
        textures.build_streaming_arena)."""
        self._queue: queue.Queue = queue.Queue()
        self._jobs = (list(mesh_jobs), list(texture_jobs))
        self._thread: threading.Thread | None = None
        self.meshes_loaded = 0
        self.textures_loaded = 0
        self.total_meshes = len(mesh_jobs)
        self.total_textures = len(texture_jobs)
        self._interrupt = threading.Event()

    # -- worker ------------------------------------------------------------

    def start(self) -> None:
        """Launched on the first frame (World::startFrame)."""
        if self._thread is not None:
            return

        def worker():
            # meshes first, then textures (loadingWorker's order)
            for job in self._jobs[0] + self._jobs[1]:
                if self._interrupt.is_set():
                    return
                self._queue.put(job())

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="loadingWorker")
        self._thread.start()

    def interrupt(self) -> None:
        self._interrupt.set()

    # -- main-thread polling -----------------------------------------------

    def poll(self, budget: int = MAX_ADOPTIONS_PER_FRAME):
        """Adopt up to `budget` finished assets; returns their list (maybe
        empty). Never blocks: a frame must not wait for loading."""
        adopted = []
        for _ in range(budget):
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, LoadedMesh):
                self.meshes_loaded += 1
            elif isinstance(item, LoadedTexture):
                self.textures_loaded += 1
            adopted.append(item)
        return adopted

    @property
    def done(self) -> bool:
        return (self.meshes_loaded >= self.total_meshes
                and self.textures_loaded >= self.total_textures)
