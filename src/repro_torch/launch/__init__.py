"""Launchers of the port: the LM trainer (`train`), the batched LM server
(`serve`) and the multi-pod dry-run (`dryrun`, with its `roofline`
terms, its meta-tensor `inputs` and `mesh.make_production_mesh`)."""
