"""Plain PnP half-quadratic splitting: from ``x = A^T y``, ``max_iter`` times
``z = prox_{stepsize/2 ||A . - y||^2}(x)``, then ``x = D(z, g_param)``."""


def run(y, op, denoise, params, max_iter):
    x = op.A_adjoint(y)
    for _ in range(max_iter):
        z = op.prox_l2(x, y, params["stepsize"])
        x = denoise(z, params["g_param"])
    return x
