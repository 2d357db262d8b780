"""The data layer of the port: corpus -> pack (R1) -> staged cache (R2)
-> ordered prefetch loader (R3) -> device prefetch, composed by
:class:`DataPipeline`.  Every stage but the last is the JAX package's
numpy code, copied."""
from repro_torch.data.cache import NetworkFS, StagedDataset  # noqa: F401
from repro_torch.data.corpus import (read_raw_corpus, synth_function,  # noqa: F401
                                     write_raw_corpus)
from repro_torch.data.device_prefetch import DevicePrefetch  # noqa: F401
from repro_torch.data.loader import (OrderedPrefetchLoader,  # noqa: F401
                                     PrefetchLoader, measure_throughput,
                                     tune_workers)
from repro_torch.data.pack import PackedShard, pack_corpus, size_reduction  # noqa: F401
from repro_torch.data.pipeline import DataPipeline, PipelineState  # noqa: F401
from repro_torch.data.tokenizer import (CLS, MASK, PAD, SEP,  # noqa: F401
                                        ByteBPETokenizer)
