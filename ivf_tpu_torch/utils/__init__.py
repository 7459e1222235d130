"""Weight conversion from the JAX package (``convert.py``) and the protobuf
wire-format helpers the ``.tfrecords`` reader needs (``tf_bundle.py``)."""
