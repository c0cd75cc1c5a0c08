"""The paper's applications (§VI-E) on the port: ALS and GAT."""
