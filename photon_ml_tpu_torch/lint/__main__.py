"""``python -m photon_ml_tpu_torch.lint`` entry point."""

import sys

from photon_ml_tpu_torch.lint.cli import main

if __name__ == "__main__":  # an import (a package walk) runs nothing
    sys.exit(main())
