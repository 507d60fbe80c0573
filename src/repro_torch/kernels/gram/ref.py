"""Plain PyTorch version of the fused Gram + projection kernel."""


def gram_t_ref(x, y):
    """x^T @ y: x (m, p), y (m, q) -> (p, q), accumulated in x's dtype
    (f32 or f64)."""
    return x.T @ y

