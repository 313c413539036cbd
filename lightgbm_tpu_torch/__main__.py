"""``python -m lightgbm_tpu_torch task=train config=train.conf`` — the
counterpart of the ``lightgbm`` binary (src/main.cpp); see cli.py."""

import sys

from .cli import main

sys.exit(main())
