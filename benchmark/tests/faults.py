"""Faults planted in the program's timed path, for the tests that see the
check refuse them (importable by name from a rank's process)."""

import torch


def unchanged(step_fn):
    """A step that returns its state unchanged (the counter still advances)."""
    from cips3d_tpu_torch.train.chunk import state_tensors

    def step(state, real, draws=None, rng=None):
        saved = [t.detach().clone() for t in state_tensors(state)]
        out = step_fn(state, real, draws=draws, rng=rng)
        with torch.no_grad():
            for t, s in zip(state_tensors(state), saved):
                if t.dtype != torch.int32:
                    t.copy_(s)
        return out

    return step


def no_ema(step_fn):
    """A step that leaves G's EMA unchanged."""

    def step(state, real, draws=None, rng=None):
        saved = [t.detach().clone() for t in state.ema.parameters()]
        out = step_fn(state, real, draws=draws, rng=rng)
        with torch.no_grad():
            for t, s in zip(state.ema.parameters(), saved):
                t.copy_(s)
        return out

    return step


def half_batch(step_fn):
    """Half of the batch left out, the mean taken over the rest."""

    def step(state, real, draws=None, rng=None):
        return step_fn(state, real[: real.shape[0] // 2], draws=draws, rng=rng)

    return step


def no_exchange():
    """The gradients' all-reduce between the ranks left out."""
    from cips3d_tpu_torch.train import step

    step.all_reduce_mean_flat = lambda tensors, mesh: list(tensors)


no_exchange.patches_module = True


def loads_jax():
    """A rank whose process holds a module named jax once the window has closed."""
    import sys
    import types

    sys.modules.setdefault("jax", types.ModuleType("jax"))


loads_jax.patches_module = True


def altered_frame(frame):
    """A served answer altered where it is produced: the frame of a camera
    turned 0.1 rad from the one asked for."""

    def f(**kw):
        return frame(**dict(kw, yaw=kw["yaw"] + 0.1))

    return f
