"""Multi-rank training over torch.distributed (counterpart of
`dp_gp_lvm_tpu/parallel/`): the (data, model) mesh, the collectives, the
placement tables, the full-batch sharded ELBOs and the runner's recipe.
"""
