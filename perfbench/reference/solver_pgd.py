"""Plain PnP proximal gradient descent: from ``x = A^T y``, ``max_iter``
times ``z = x - stepsize A^T (A x - y)``, then ``x = D(z, g_param)``."""


def run(y, op, denoise, params, max_iter):
    x = op.A_adjoint(y)
    for _ in range(max_iter):
        z = x - params["stepsize"] * op.grad(x, y)
        x = denoise(z, params["g_param"])
    return x
