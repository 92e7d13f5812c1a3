"""The TPU experiments' kernels (counterpart of the repo's experiments/):
the per-ray threaded-BVH walk (trace_wavefront.py), the Plücker block
(trace_plucker.py, over ops/plucker.py) and the Möller-against-Plücker
loop benchmark (bench_mxu_isect.py), each on the card through
hand-written CUDA."""
