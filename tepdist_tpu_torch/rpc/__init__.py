"""The RPC service: the wire protocol, the server, the client and the
in-process transport (the port of ``tepdist_tpu/rpc/``)."""
