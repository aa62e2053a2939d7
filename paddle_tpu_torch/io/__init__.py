"""paddle.io of the port: datasets, samplers and the DataLoader (port of
`paddle_tpu/io/`)."""
from .dataloader import DataLoader, default_collate_fn  # noqa: F401
from .dataset import (  # noqa: F401
    BatchSampler,
    ChainDataset,
    ComposeDataset,
    ConcatDataset,
    Dataset,
    DistributedBatchSampler,
    IterableDataset,
    RandomSampler,
    Sampler,
    SequenceSampler,
    Subset,
    SubsetRandomSampler,
    TensorDataset,
    WeightedRandomSampler,
    random_split,
)


def get_worker_info():
    """Inside a DataLoader worker: its WorkerInfo (id, num_workers,
    dataset); None in the main process."""
    from . import dataloader as _dl

    return _dl._worker_info
