"""`python -m trivy_tpu_torch ...` runs the port's CLI."""

import sys

from trivy_tpu_torch.cli.main import main

sys.exit(main())
