"""Plain PyTorch versions of the fused Gram + projection kernel, and an
emulation of its ``wgmma`` body's arithmetic (tests and chip_smoke
only)."""
import torch


def gram_t_ref(x, y):
    """x^T @ y: x (m, p), y (m, q) -> (p, q), accumulated in x's dtype
    (f32 or f64)."""
    return x.T @ y


def gram_fused_ref(Y, V):
    """Y^T [Y | V^T] for Y (m, p) and V (k, m) -> (p, p + k)."""
    return gram_t_ref(Y, torch.cat([Y, V.T], dim=1))


def round_tf32(a):
    """f32 ``a`` rounded to tf32 as ``cvt.rna.tf32.f32`` does it: to the
    nearest value with 10 explicit mantissa bits, ties away from zero, by
    integer operations on the bit pattern (add half of the last kept bit
    to the magnitude, clear the 13 dropped bits)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate_tf32(a):
    """f32 ``a`` as the tensor cores read a tf32 operand: its 13 low
    mantissa bits dropped (toward zero)."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(a):
    """(hi, lo) as the tensor cores see the kernel's split of each value:
    hi = tf32(a), and lo = a - hi (exact in f32) with its low 13 bits
    dropped."""
    hi = round_tf32(a)
    return hi, truncate_tf32(a - hi)


def gram_t_tf32(x, y, passes: int = 3):
    """x^T y from tf32 products accumulated in f32: ``passes`` = 3 is the
    wgmma body's 3xTF32 (hi.lo + lo.hi + hi.hi); 1 is a single TF32
    product (hi.hi). A product of two tf32 values is exact in f32, so
    only the accumulation order differs from the card's."""
    if passes not in (1, 3):
        raise ValueError(f"passes is 1 or 3, not {passes}")
    xh, xl = split_tf32(x)
    yh, yl = split_tf32(y)
    if passes == 1:
        return xh.T @ yh
    return (xh.T @ yl + xl.T @ yh) + xh.T @ yh
