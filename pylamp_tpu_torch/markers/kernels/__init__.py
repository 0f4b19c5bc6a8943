"""CUDA kernels of the marker engine (m2g, advect, rebucket) and their
wrappers; each module keeps its plain PyTorch version beside the kernel."""
import torch


def check_markers(bm, what: str, positions_only=False):
    """The marker kernels take contiguous CUDA (ny, nx, K) streams: f32
    x, y[, T], int32 mat, bool valid."""
    shape = tuple(bm.x.shape)
    want = [("x", torch.float32), ("y", torch.float32),
            ("valid", torch.bool)]
    if not positions_only:
        want += [("T", torch.float32), ("mat", torch.int32)]
    for name, dtype in want:
        t = getattr(bm, name)
        if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_cuda
                or not t.is_contiguous()):
            raise ValueError(
                f"{what} kernel: markers.{name} must be a contiguous CUDA "
                f"{dtype} tensor of shape {shape}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
