'''Device ops of the extraction path in PyTorch, with the two hand-written
CUDA kernels (``roi_align_kernel``, ``clean_kernel``) beside their plain
PyTorch versions.'''
