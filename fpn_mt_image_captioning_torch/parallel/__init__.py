"""Data × model parallelism over ranks (port of
``fpn_mt_image_captioning_tpu/parallel``): ``multihost`` brings up
``torch.distributed`` from the launcher's environment, ``mesh`` builds the
(data, model) ``DeviceMesh`` and places each parameter by the Megatron rules,
``collectives`` holds the few collectives the model and the step issue, and
``train`` shards a training state and builds the sharded step, encode and
beam search."""
