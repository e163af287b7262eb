"""What the four examples share: the working folder, host copies of the
figures they print, and the command line."""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def work_folder(path, prefix):
    """``path`` (made if missing), or a new temporary folder."""
    if path is None:
        return tempfile.mkdtemp(prefix=prefix)
    os.makedirs(path, exist_ok=True)
    return str(path)


def host(a):
    """A tensor (on any device) or an array as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def cli(main, description):
    """Run ``main(device=, workdir=)`` from the command line."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default=None,
                        help="where the port runs: cuda (the default) or "
                             "cpu")
    parser.add_argument("--workdir", default=None,
                        help="folder for the synthetic series (default: a "
                             "new temporary one)")
    args = parser.parse_args()
    main(device=args.device, workdir=args.workdir)
