"""The benchmark's own host spans around the port's layers, for traced runs.

``installed()`` wraps a few of the program's functions, for the length of
a ``with`` block, in ``torch.profiler.record_function`` ranges named
``bench.<layer>``, so that the profiler's trace holds them beside the
device's work: they label the device's idle gaps and time the decode's
plan. They neither synchronise nor change what the functions do.
``step_timers()`` attaches the encoder's own ``StepTimer`` to every
``SRLAEncoder`` made inside its block and collects their seconds a step;
the timer synchronises at every step, so it runs outside the window.
"""

from __future__ import annotations

import contextlib
import functools
import importlib

# (module, attribute path, span name): the layers from the entry down.
WRAPPED = (
    ("srla_tpu_torch.decoder", "SRLADecoder.plan", "plan"),
    ("srla_tpu_torch.decoder", "upload_stream", "upload"),
    ("srla_tpu_torch.decoder", "decode_blocks", "kernels"),
    ("srla_tpu_torch.decoder", "_place", "place"),
    ("srla_tpu_torch.encoder", "SRLAEncoder._upload", "upload"),
    ("srla_tpu_torch.host_encoder", "SRLAEncoder._variable_spans",
     "vsearch"),
    ("srla_tpu_torch.encoder", "SRLAEncoder._encode_spans", "typing"),
    ("srla_tpu_torch.encoder", "SRLAEncoder._launch_group", "kernels"),
    ("srla_tpu_torch.encoder", "SRLAEncoder._finish_group", "finish"),
)


def _wrap(fn, name):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with record_function("bench." + name):
            return fn(*args, **kwargs)
    return inner


@contextlib.contextmanager
def installed():
    saved = []
    try:
        for mod_name, path, name in WRAPPED:
            obj = importlib.import_module(mod_name)
            *outer, attr = path.split(".")
            for part in outer:
                obj = getattr(obj, part)
            fn = obj.__dict__[attr]
            saved.append((obj, attr, fn))
            setattr(obj, attr, _wrap(fn, name))
        yield
    finally:
        for obj, attr, fn in reversed(saved):
            setattr(obj, attr, fn)


@contextlib.contextmanager
def step_timers(device, seconds: dict):
    """Every SRLAEncoder made in the block gets a StepTimer; at the end
    ``seconds`` holds their summed seconds a step."""
    from srla_tpu_torch import encoder
    cls = encoder.SRLAEncoder
    init = cls.__init__
    timers = []

    def timed_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.timer = encoder.StepTimer(device)
        timers.append(self.timer)

    cls.__init__ = timed_init
    try:
        yield timers
    finally:
        cls.__init__ = init
        for t in timers:
            for k, v in t.seconds.items():
                seconds[k] = seconds.get(k, 0.0) + v
