"""PyTorch/CUDA port of the ``stereo_tpu`` stereo depth framework.

Same subpackage layout and public names as ``stereo_tpu``; tensors are
CHW/NCHW float32 in 0..255.  The hot stages of the single-view path run in
hand-written CUDA kernels (``csrc/``) on CUDA tensors and in their plain
PyTorch versions on CPU tensors.
"""
