"""CLI entry point: ``python -m repro_torch.scenarios --check | --regen``.

Thin alias for ``repro_torch.scenarios.golden``'s main (running the submodule
directly trips runpy's found-in-sys.modules warning because the package
``__init__`` imports it).
"""
import sys

from .golden import main

if __name__ == "__main__":
    sys.exit(main())
