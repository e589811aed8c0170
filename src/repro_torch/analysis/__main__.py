"""``python -m repro_torch.analysis`` — the port's twin of tools/analyze.py."""
import sys

from repro_torch.analysis.runner import main

sys.exit(main())
