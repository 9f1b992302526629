"""The port's device operations (port of ``vlog_tpu/ops``):

- ``colorspace``   BT.601/BT.709 YUV 4:2:0 <-> RGB, chroma 4:2:0 <-> 4:4:4
- ``resize``       separable resampling matrices, the one-call resize API
                   and the plain version of the fused kernel
- ``fused_resize`` the hand-written CUDA ladder resize (csrc/fused_resize.cu)
- ``motion_search`` the hand-written CUDA HEVC motion search
                   (csrc/hevc_motion_search.cu)
- ``h264_deblock`` the hand-written CUDA H.264 deblocking filter
                   (csrc/h264_deblock.cu)
- ``cuda_build``   the nvcc build of the three kernels
- ``transform``    H.264 4x4 integer transforms and quantization (exact)
- ``bitproxy``     the rate controller's bit-cost proxy
"""

from vlog_tpu_torch.ops.colorspace import (  # noqa: F401
    rgb_to_yuv420,
    yuv420_to_rgb,
    yuv420_to_yuv444,
    yuv444_to_yuv420,
)
from vlog_tpu_torch.ops.resize import (  # noqa: F401
    ladder_resize_yuv420,
    resize_plane,
    resize_yuv420,
)
from vlog_tpu_torch.ops import transform  # noqa: F401
