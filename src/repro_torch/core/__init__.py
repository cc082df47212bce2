"""DAG-AFL core (port of ``repro.core``): ledger, tip selection, signature
contract, verification, aggregation and the sequential coordinator."""
