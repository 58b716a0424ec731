"""Client/server RPC (reference rpc/ + pkg/rpc; copy of trivy_tpu/rpc/).

Twirp-style JSON-over-HTTP: POST /twirp/trivy.scanner.v1.Scanner/Scan and
the trivy.cache.v1.Cache methods, same split as the reference — the client
runs artifact analysis locally and pushes blobs into the server's cache;
the server runs detection against its own advisory DB on the card.
"""
