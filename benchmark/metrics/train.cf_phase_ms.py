"""train.cf_phase_ms: device ms of a CF step: the program's
``train.cf_phase`` span (``Trainer.train_one_epoch``: the phase's steps
and its loss's read-back) on the stream's clock, over its count times the
CF steps an epoch."""

from benchmark import program_spans


def read(run):
    if not run["steps"]:
        return None
    return program_spans.device_ms("train.cf_phase", run["steps"]["cf"])
