"""Networking: for now the host storage part of the P2P data plane
(:mod:`.p2p`); the transport, client and server come with the network
plane."""
