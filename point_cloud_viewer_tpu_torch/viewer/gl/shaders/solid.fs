#version 330 core
uniform vec4 color_u;
out vec4 frag_color;
void main() { frag_color = color_u; }
