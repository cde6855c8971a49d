"""The mesh tier: distributed stages over n shards on one device
(counterpart of ``presto_tpu/parallel``)."""
