from .ops import adamw_cuda, square_sums_cuda

__all__ = ["adamw_cuda", "square_sums_cuda"]
