from .api import (BadRequestError, DepthEstimationServer, MicroBatcher,
                  decode_png_to_pipeline_image, encode_disparity_png)

__all__ = ["BadRequestError", "DepthEstimationServer", "MicroBatcher",
           "decode_png_to_pipeline_image", "encode_disparity_png"]
