"""The benchmark of the PyTorch and CUDA captioner (``fpn_mt_image_captioning_torch``) on one H100."""
