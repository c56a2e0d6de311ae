import sys

from sextans_tpu_torch.cli import main

sys.exit(main())
