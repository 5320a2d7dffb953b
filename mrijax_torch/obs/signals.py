"""Preemption-graceful shutdown via POSIX signals.

Counterpart of ``mrijax/obs/signals.py``: SLURM sends SIGUSR1 600 s before
the time limit (``--signal=SIGUSR1@600``) and SIGTERM on scancel; the handler
sets a module flag that the trainer polls between steps and epochs, so the
checkpoint and the metrics finish before the kill.
"""

import signal

_terminate_requested = False


def _handler(signum, frame):  # pragma: no cover - signal path
    global _terminate_requested
    _terminate_requested = True
    print(f"[mrijax_torch.obs.signals] Received signal {signum}; "
          "will stop at the next safe point.")


def install_signal_handlers(signals=(signal.SIGUSR1, signal.SIGTERM)) -> None:
    for s in signals:
        try:
            signal.signal(s, _handler)
        except (ValueError, OSError):  # non-main thread / unsupported
            pass


def should_terminate() -> bool:
    return _terminate_requested


def reset_termination() -> None:
    global _terminate_requested
    _terminate_requested = False
