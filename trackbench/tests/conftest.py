"""The CPU tests run several workers at once: keep each to two threads."""
import torch

torch.set_num_threads(2)
