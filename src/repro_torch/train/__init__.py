"""Training and serving steps of the LM side: AdamW (``optimizer``), the
train step with microbatch accumulation (``train_step``), gradient
compression, checkpoints, fault tolerance, and the serving steps
(``serve_step``).  Sharded training (``sharding``, ``pipeline_parallel``)
waits for a device mesh (ROADMAP queue A)."""
