from .right_view_synthesis import RightViewSynthesis

__all__ = ["RightViewSynthesis"]
