"""The benchmark's CPU tests: the repository root on the path, few
threads."""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
torch.set_num_threads(4)
