from .catalog import CatalogDataset, build_catalog, recall_at_k, recall_chunked, rerank_batch
from .featurize import Featurizer, pad_batch, stack_examples
from .labels import QueryLabelIndex, load_multimodal_labels
from .packed import MANIFEST, PackedDataset, write_packed_shards
from .pipeline import PipelineStats, PrefetchIterator, batches_from_files, iter_batches
from .sampling import HardNegativeSampler, SamplerConfig
from .tsv import MAX_BOXES, MAX_LABEL_TOKENS, MAX_QUERY_LEN_AB, MAX_QUERY_LEN_L, RawExample, parse_line

__all__ = [
    "CatalogDataset",
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
    "build_catalog",
    "iter_batches",
    "load_multimodal_labels",
    "pad_batch",
    "parse_line",
    "recall_at_k",
    "recall_chunked",
    "rerank_batch",
    "stack_examples",
    "write_packed_shards",
]
