"""prosper_tpu_torch — the PyTorch + CUDA port of prosper_tpu.

The JAX package `prosper_tpu` is the reference; this package mirrors its
layout (mathx/, scene/, ops/, render/) so each module's counterpart is
found by path. Plain tensor code is PyTorch; every Pallas TPU kernel on a
ported path is a hand-written CUDA kernel under csrc/, launched by a
wrapper that runs the kernel's plain PyTorch version only for CPU tensors.

The package imports neither JAX nor anything of prosper_tpu, not even
its numpy-only modules: it keeps its own copies (accel/bvh.py,
mathx/transforms.py, io/image.py, io/dds.py, io/ktx.py, the scene path
under scene/, testing.py); scene/native.py compiles the repo's cpp/asset_pipeline.cpp
itself. tests/test_torch_scene.py checks this in a subprocess. All four
render modes are ported: the path tracer (render/pt.py, with thin-lens
DoF, environment lighting from ops/ibl.py and stochastic alpha), the deferred
renderer (render/deferred.py: G-buffer with optional two-phase meshlet
culling, clustered shading, IBL, the post chain of ops/taa.py, bloom.py,
dof.py and particles.py), the forward renderer (render/forward.py)
and ReSTIR DI (render/restir.py), on procedural scenes (testing.py) and
glTF scenes (scene/world.py); entry.py returns the frame call of each,
and config.py holds the kernel policy.
"""

__version__ = "0.1.0"
