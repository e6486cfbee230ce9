"""The mesh the ACAM service shards over (`context`) and forced meshes for
tests, benches and one-card runs (`forcemesh`)."""
