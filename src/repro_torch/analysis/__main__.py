"""``python -m repro_torch.analysis`` — the port's trace-level checks."""

import sys

from repro_torch.analysis import main

if __name__ == "__main__":
    sys.exit(main())
