"""Weight conversion from the JAX package (``convert.py``), checkpoints
(``checkpoint.py``), result files (``results.py``) and the protobuf
wire-format helpers the ``.tfrecords`` reader needs (``tf_bundle.py``)."""
