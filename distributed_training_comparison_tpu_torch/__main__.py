"""``python -m distributed_training_comparison_tpu_torch --serve ...``"""

import sys

from .entry import run

if __name__ == "__main__":
    run(sys.argv[1:])
