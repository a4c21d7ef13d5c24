from repro_torch.data.pipeline import (MarkovCorpus, make_worker_streams,  # noqa: F401
                                       stacked_batch, stacked_segment)
