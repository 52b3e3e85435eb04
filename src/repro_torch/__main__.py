"""The `repro_torch` command: dispatch to the launchers.

  python -m repro_torch calibrate --cpu --quick --out profile.json
  python -m repro_torch train --arch qwen1.5-0.5b --reduced --cpu --steps 3
  python -m repro_torch train --arch mamba2-2.7b --reduced --cpu --steps 3
  python -m repro_torch serve --arch qwen1.5-0.5b --reduced --cpu

Each subcommand is the matching `repro_torch.launch.<name>` module,
imported only after dispatch.  `dryrun` and `perf-probe` (the JAX
package's lowering over 512 devices with model and pipe axes) are not
ported yet: they print so and return 2.
"""
from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "calibrate": "repro_torch.launch.calibrate",
    "train": "repro_torch.launch.train",
    "serve": "repro_torch.launch.serve",
}
NOT_PORTED = ("dryrun", "perf-probe")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        names = ", ".join(sorted(COMMANDS))
        print(f"usage: python -m repro_torch <command> [args]\n"
              f"commands: {names} (not ported yet: "
              f"{', '.join(NOT_PORTED)})")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd in NOT_PORTED:
        print(f"{cmd} is not ported yet: it lowers over 512 devices with "
              f"model and pipe axes (ROADMAP section 1 items 5.2-5.4)",
              file=sys.stderr)
        return 2
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; known: {sorted(COMMANDS)}",
              file=sys.stderr)
        return 2
    mod = importlib.import_module(COMMANDS[cmd])
    return mod.main(rest)


if __name__ == "__main__":
    sys.exit(main())
