'''moseq2-detectron-extract-tpu, PyTorch/CUDA port.

A second package beside ``moseq2_detectron_extract_tpu`` (the JAX reference)
that runs the extraction device path in PyTorch on an NVIDIA GPU. The two
Pallas TPU kernels of the reference become hand-written CUDA kernels
(``csrc/``), built with ``nvcc`` at first use and loaded through ``ctypes``.

The package imports torch and numpy only: no jax, no cv2/h5py/yaml/click and
nothing of the JAX package. Entry points default to ``device='cuda'`` and
raise when no GPU is present; tests pass ``device='cpu'``.
'''

__version__ = '0.1.0'
