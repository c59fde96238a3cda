from .featurize import Featurizer, pad_batch, stack_examples
from .labels import QueryLabelIndex, load_multimodal_labels
from .packed import MANIFEST, PackedDataset, write_packed_shards
from .pipeline import PipelineStats, PrefetchIterator, batches_from_files, iter_batches
from .sampling import HardNegativeSampler, SamplerConfig
from .tsv import MAX_BOXES, MAX_LABEL_TOKENS, MAX_QUERY_LEN_AB, MAX_QUERY_LEN_L, RawExample, parse_line

__all__ = [
    "Featurizer",
    "HardNegativeSampler",
    "MANIFEST",
    "MAX_BOXES",
    "MAX_LABEL_TOKENS",
    "MAX_QUERY_LEN_AB",
    "MAX_QUERY_LEN_L",
    "PackedDataset",
    "PipelineStats",
    "PrefetchIterator",
    "QueryLabelIndex",
    "RawExample",
    "SamplerConfig",
    "batches_from_files",
    "iter_batches",
    "load_multimodal_labels",
    "pad_batch",
    "parse_line",
    "stack_examples",
    "write_packed_shards",
]
