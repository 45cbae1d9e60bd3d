"""Node-side helpers of the port: what the crypto sidecar reads from a
node's configuration files."""
