"""A tensor on a device the port's kernel wrappers do not run on.

The wrappers take CPU tensors (the plain versions), CUDA tensors (the
kernels) and ``meta`` tensors (shapes only), and raise on any other device.
``other_device(*shape)`` is a storage-less tensor whose device is ``xpu``,
which a CPU-only build of PyTorch can still describe: any operation on it
raises, so a wrapper that reads its device before touching it is what a
test of that rule needs.
"""
import torch


class _OtherDevice(torch.Tensor):
    @staticmethod
    def __new__(cls, shape, dtype):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype, device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise NotImplementedError(f"{func} on a stand-in xpu tensor")


def other_device(*shape, dtype=torch.float32) -> torch.Tensor:
    return _OtherDevice(tuple(shape), dtype)
