from .binning import BinMapper, greedy_find_bin
from .dataset import BinnedDataset, Metadata
