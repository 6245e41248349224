from .pipeline import ShardedLoader
from .replay import (ReplayableStream, batch_fingerprint, indexed_classification_stream,
                     indexed_token_stream)
from .synthetic import synthetic_classification
