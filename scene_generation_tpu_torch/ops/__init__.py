"""Tensor ops of the port: sampling matrices, scene-graph gather/pool, the
layout compositor, the generator stem and the ROI crop (the last three
with CUDA kernels in ``csrc/``, built by ``_cuda``)."""
