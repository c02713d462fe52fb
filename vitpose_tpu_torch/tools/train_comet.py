"""Training CLI with experiment tracking: `tools/train.py` whose
train.log.json records stream to comet-ml where `comet_ml` is installed.

    python -m vitpose_tpu_torch.tools.train_comet CONFIG [train.py's args]

Counterpart of the JAX package's tools/train_comet.py (the fork's
tools/train_comet.py). Without `comet_ml` (installed on neither machine)
it says so and trains exactly as `python -m vitpose_tpu_torch.tools.train`
does, on the card unless `--device cpu` is given. With it, an Experiment
(project COMET_PROJECT_NAME, default 'vitpose_tpu') gets the argv and the
config file, and a thread tails `WORK_DIR/train.log.json` into it
(`_tail_log_to_comet`) while the runner trains; the work dir is
`--work-dir`, else the config's `runtime.work_dir` after `--cfg-options`,
else 'work_dir', where the runner puts it.
"""
from __future__ import annotations

import json
import os
import sys
import threading

from . import train as train_cli
from ..utils.config import apply_options, load_config


def _make_experiment():
    try:
        import comet_ml
    except ImportError:
        print('comet_ml not installed; training with the train.log.json '
              'log only')
        return None
    return comet_ml.Experiment(
        project_name=os.environ.get('COMET_PROJECT_NAME', 'vitpose_tpu'))


def _tail_log_to_comet(experiment, log_path, stop_event, poll_s=5.0):
    """Stream the train.log.json records into `experiment` as they are
    written: each record's numbers but step, epoch and iter through
    `log_metrics(metrics, step=record's step, else its epoch, else 0)`.

    Reads in binary from the last byte offset and keeps a trailing partial
    line for the next poll; once `stop_event` is set, one last pass sends
    what was written since the previous poll. Lines that are not JSON are
    skipped."""
    pos = 0
    buf = b''
    while True:
        stopping = stop_event.is_set()
        if os.path.exists(log_path):
            with open(log_path, 'rb') as f:
                f.seek(pos)
                buf += f.read()
                pos = f.tell()
            lines = buf.split(b'\n')
            buf = lines.pop()          # b'' after a complete last line
            for line in lines:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                step = rec.get('step', rec.get('epoch', 0))
                metrics = {k: v for k, v in rec.items()
                           if isinstance(v, (int, float))
                           and k not in ('step', 'epoch', 'iter')}
                if metrics:
                    experiment.log_metrics(metrics, step=int(step))
        if stopping:
            return
        stop_event.wait(poll_s)


def _work_dir(args):
    """Where the runner will write: --work-dir, else the config's
    runtime.work_dir with --cfg-options applied, else 'work_dir'."""
    if args.work_dir:
        return args.work_dir
    cfg = apply_options(load_config(args.config), args.cfg_options)
    return cfg.get('runtime', {}).get('work_dir', 'work_dir')


def main(argv=None, experiment=None):
    """Train as tools/train.py does; returns its final TrainState.
    `experiment` (a comet_ml Experiment, or anything with log_metrics,
    log_parameters, log_asset and end) is made here when not given."""
    argv = sys.argv[1:] if argv is None else list(argv)
    experiment = experiment or _make_experiment()
    if experiment is None:
        return train_cli.main(argv)
    args = train_cli.parser().parse_args(argv)
    experiment.log_parameters({'argv': ' '.join(argv)})
    experiment.log_asset(args.config)
    stop = threading.Event()
    tailer = threading.Thread(
        target=_tail_log_to_comet,
        args=(experiment, os.path.join(_work_dir(args), 'train.log.json'),
              stop), daemon=True)
    tailer.start()
    try:
        return train_cli.main(argv)
    finally:
        stop.set()
        tailer.join(timeout=30)
        experiment.end()


if __name__ == '__main__':
    main()
