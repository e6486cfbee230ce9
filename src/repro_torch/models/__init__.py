"""CNN front ends (`cnn`: the paper's Fig. 5 student and the ResNet
teacher) and shared layers (`layers.chunked_attention`)."""
