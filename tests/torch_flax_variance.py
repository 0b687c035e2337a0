"""Flax's BatchNorm with the two-pass batch variance, for the port's tests.

``nn.BatchNorm`` takes ``use_fast_variance=True`` by default (flax 0.12):
the batch variance as ``max(0, E[x^2] - E[x]^2)`` in float32, which loses
digits to cancellation where a channel's mean is large against its spread,
as on the detector's first layers over 0-255 windows.  The port's
``FlaxBatchNorm2d`` takes two passes (``torch.var_mean``).  Inside
:func:`flax_two_pass_variance` every Flax ``BatchNorm`` traced in this
process computes ``E[(x - E[x])^2]`` instead, so a JAX run of a recipe can
be held to the same arithmetic as the port's without editing the JAX
package.  Enter it in the process that traces the model (a worker's own
function, not a ``sitecustomize``)."""
import contextlib


@contextlib.contextmanager
def flax_two_pass_variance():
    """While the block runs, ``flax.linen.normalization._compute_stats``
    passes ``use_fast_variance=False``; the original comes back after.
    Steps traced inside keep the two-pass variance after the block."""
    from flax.linen import normalization

    compute = normalization._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute(*args, **kwargs)

    normalization._compute_stats = two_pass
    try:
        yield
    finally:
        normalization._compute_stats = compute
