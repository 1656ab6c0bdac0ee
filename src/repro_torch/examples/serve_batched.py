"""DEPRECATED: fixed-batch serving was replaced by the continuous-batching
server in ``repro_torch.launch.serve`` (DecodeSession + request handles).

This wrapper is kept so existing invocations keep working: it forwards to
the new server (``--policy static`` reproduces the old drain-a-batch
scheduling), adding ``--reduced`` where it is absent; ``--device`` passes
through. Prefer:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
      --reduced
"""

from __future__ import annotations

import sys
import warnings

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> dict:
    """Warn, then ``serve.main`` on ``argv`` (the command line's when
    None) with ``--reduced``; returns its summary."""
    warnings.warn(
        "repro_torch.examples.serve_batched is deprecated; use "
        "`python -m repro_torch.launch.serve` (continuous batching) instead",
        DeprecationWarning, stacklevel=1)
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--reduced" not in argv:
        argv.append("--reduced")
    return serve_main(argv)


if __name__ == "__main__":
    main()
