from .api import (BadRequestError, DepthEstimationServer, MicroBatcher,
                  create_asgi_app, decode_png_to_pipeline_image,
                  encode_disparity_png)

__all__ = ["BadRequestError", "DepthEstimationServer", "MicroBatcher",
           "create_asgi_app", "decode_png_to_pipeline_image",
           "encode_disparity_png"]
