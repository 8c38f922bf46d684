"""Core structures of the port: SORT, vertex table, edge pool and the
``RadixGraph`` facade (counterparts of ``repro.core``)."""
